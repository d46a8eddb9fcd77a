"""The per-layer quantities the metric files of ``benchmark/metrics``
read from a run (``benchmark.run.RunData``).  Each returns None where the
run holds nothing to read: no steps, no trace, no iterations."""
from __future__ import annotations

from benchmark.harness import roofline


def host_reads_per_step(run):
    """Host reads of the port's gates and IPM loop a step, counted by the
    port (``core.step.HOST_READS``, ``lcp.pdipm.HOST_READS``)."""
    if not run.steps:
        return None
    return run.counted("host_reads.") / run.steps


def ipm_iterations(run):
    """Mean per-world iterations of ``lcp_solve_full`` on the cell's
    batches."""
    if run.lcp_iters is None or not len(run.lcp_iters):
        return None
    return float(run.lcp_iters.double().mean())


def device_idle_pct(run):
    """Share of the traced window in which no device operation ran."""
    tl = run.timeline
    if tl is None:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)


def launches_per_step(run):
    """Device kernels the profiler saw a step, all of them."""
    if run.timeline is None or not run.steps:
        return None
    return len(run.timeline.kernels()) / run.steps


def lcp_roofline_pct(run):
    """Least time of a batch's solve (its per-world iterations, averaged
    over the cell's batches, which the calls cycle through) over the
    summed device kernel time of a call."""
    tl, iters = run.timeline, run.lcp_iters
    if tl is None or iters is None or not run.calls:
        return None
    conf = run.loop.conf
    N, C = conf["bodies"], conf["c_max"]
    n, m, K = 3 * N, 4 * C, 2 * C
    per_batch = iters.reshape(-1, conf["worlds"]).double().cpu()
    least = [roofline.least_seconds(
        sum(roofline.lcp_flops(n, K, int(i)) for i in row.tolist()),
        conf["worlds"] * roofline.lcp_bytes(n, m, C)) for row in per_batch]
    kernel = tl.kernel_s() / run.calls
    return 100.0 * (sum(least) / len(least)) / kernel


def step_roofline_pct(run):
    """Least time of a batched step (every world at the step's mean
    batch-loop iterations, the IPM loop's host reads a step) over the
    summed device kernel time of a step."""
    tl = run.timeline
    if tl is None or not run.steps:
        return None
    conf = run.loop.conf
    N, C = conf["bodies"], conf["c_max"]
    iters = run.counted("host_reads.ipm_loop") / run.steps
    B = conf["worlds"]
    flops = B * roofline.step_flops(N, C, 2 * C, iters)
    least = roofline.least_seconds(flops, B * roofline.step_bytes(N))
    return 100.0 * least / (tl.kernel_s() / run.steps)
