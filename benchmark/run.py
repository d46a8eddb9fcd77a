"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Usage, from the root of a checkout::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A run builds the cell's inputs from the seed, builds and warms the program
on them (set-up, reported as ``setup_s`` from the start of the process),
drives the cell's loop for ``--seconds`` (the window: from its first call
to the synchronise after its last), then frees the program's state and
judges what the window produced against the plain reference.  With
``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` the window, at most ``TRACE_WINDOW_S`` long, runs under
``torch.profiler`` and the metrics are its per-layer ones, read by
``benchmark/metrics/<name>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (calls in the window), ``failed`` (calls that failed; a
failing call ends the run without a result), ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared, with its limit.  The same numbers are the last lines of
standard error.  Without a CUDA device the run exits with code 2 and
prints no result; if JAX or the JAX package is loaded once the window has
closed, with code 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "lcp_physics_tpu")
# A traced run's window is at most this long: the profiler's trace of a
# longer one takes minutes to read back.
TRACE_WINDOW_S = 20.0


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def pin_caches():
    """Kernel caches of torch and Triton at fixed paths in the checkout
    (the port's own nvcc libraries are built into its ``build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _quantile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=float), q))


class RunData:
    """What a per-layer metric's reader reads: the cell, its loop, the
    window's calls and steps, the port's counters over the window and, in
    a traced run, the device timeline."""

    def __init__(self, cell, loop, calls, counters, timeline, window_s):
        self.cell, self.loop = cell, loop
        self.calls = calls
        self.steps = calls * loop.steps_per_call
        self.counters = counters
        self.timeline = timeline
        self.window_s = window_s
        self.lcp_iters = None

    def counted(self, prefix):
        return sum(v for k, v in self.counters.items()
                   if k.startswith(prefix))


def run(name, seed, seconds, trace, device="cuda", overrides=None,
        t_start=None, bench=None):
    """One run of cell ``name``; returns the result object.  ``overrides``
    ({"config": {...}, "traffic": {...}}) replace entries of the cell's
    files, ``bench`` stands for ``BENCHMARK.json`` (tests only; the
    command passes neither)."""
    import torch

    from benchmark.harness import check, program, spec, timeline

    t_start = T_START if t_start is None else t_start
    cell = spec.cell(name, bench)
    for part, new in (overrides or {}).items():
        getattr(cell, part).update(new)
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        program.build()
    loop = spec.loop(cell.traffic["loop"])(cell, seed, device)
    loop.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {name}: set-up {setup_s:.3f} s")

    if cuda:
        def stamp():
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        between = lambda a, b: a.elapsed_time(b)
    else:
        stamp = time.perf_counter
        between = lambda a, b: 1e3 * (b - a)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts) if trace else None
    if trace:
        seconds = min(seconds, TRACE_WINDOW_S)
    before = program.counters()
    units = calls = 0
    with prof or contextlib.nullcontext():
        sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(timeline.WINDOW):
            marks = [stamp()]
            while True:
                units += loop.call()
                calls += 1
                marks.append(stamp())
                if time.perf_counter() - t0 >= seconds:
                    break
            sync()
        window_s = time.perf_counter() - t0
        after = program.counters()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    call_ms = [between(a, b) for a, b in zip(marks, marks[1:])]
    log(f"[bench] window {window_s:.3f} s, {calls} calls, {units} "
        f"{loop.unit}; call ms over all {len(call_ms)} calls: median "
        f"{_quantile(call_ms, 50):.4f}, p95 {_quantile(call_ms, 95):.4f}, "
        f"max {max(call_ms):.4f}")

    metrics, breakdown, dev = {}, None, {}
    if not trace:
        values = {"setup_s": setup_s, "call_ms_p95": _quantile(call_ms, 95)}
        rate = units / window_s
        for m in cell.end_to_end:
            if m["name"] in values:
                v = values[m["name"]]
            elif m["unit"].split("/")[0] == loop.unit:
                v = rate
            else:
                raise ValueError(f"{name}: no reading for {m['name']}")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        tl = timeline.read(prof) if cuda else None
        data = RunData(name, loop, calls,
                       {k: after[k] - before[k] for k in after}, tl,
                       window_s)
        if hasattr(loop, "iterations"):
            data.lcp_iters = loop.iterations()
        for m in cell.per_layer:
            v = spec.reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tl is not None:
            breakdown = {"device_ops": tl.top_device_ops(),
                         "idle_gaps": tl.idle_by_host()}
            dev = {"busy_s": tl.busy_s(), "window_s": tl.window_s}

    evidence = loop.evidence()
    loop.free()
    if cuda:
        torch.cuda.empty_cache()
    numbers, _ = check.check(loop, evidence)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_obj = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(device) if cuda
                  else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak), **dev}
    if cuda:
        device_obj["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": calls, "failed": 0,
              "metrics": metrics, "device": device_obj}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    import torch

    from benchmark.harness import spec
    chips = {w["name"]: w["chips"] for w in
             spec.load_json(spec.BENCHMARK)["workloads"]}.get(args.workload,
                                                              1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < chips):
        log(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
            f"nothing is measured")
        return 2
    torch.set_num_threads(2)
    result = run(args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        log(f"benchmark: modules of JAX or the JAX package are loaded: "
            f"{found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
