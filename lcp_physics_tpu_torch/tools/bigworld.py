"""Big single worlds on the port (counterpart of the JAX package's
``tools/bigworld.py``).

The dense circle grid of the benchmark scaled to N = 64 ... 400 bodies in
one world: which factor path each size lands on, and its host and device
time per step.  The rotated Schur system of a contact step has K2 = 2 *
c_max + q rows (q = 0 here), c_max = 2N by default (a dense grid's
contacts, right and up neighbours):

* up to ``linalg.MAX_BLOCKED_N`` = 1536 rows the blocked LU over
  T = ceil(K2 / 128) panels, each diagonal panel inverted by the rank-16
  Gauss-Jordan kernel K4 at float32 (the scalar K5 at float64);
* past it, as in the JAX package, the pivoted library LU
  (``torch.linalg.lu_factor``; ``lcp.pdipm.resolve_backend``, counted in
  ``lcp.pdipm.ROUTES["library_lu"]``).

``CONFIGS`` are the JAX tool's sizes at float32 (N, B, c_max): the
flagship 64-body grid, 144 and 256 bodies at the default c_max, 256 at
c_max = 448 (7 panels) and 361 at c_max = 768 (K2 = 1536, 12 panels, the
cap); the hull grid at N = 144 with ``hull_pair_budget`` 0 and 1024; and
N = 400 at c_max = 800 (K2 = 1600), past the cap.

Usage: ``python -m lcp_physics_tpu_torch.tools.bigworld``: every
configuration on the card, ``STEPS`` steps each, one JSON record a line.
It raises without a card; ``probe`` also runs on a CPU device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                        make_scene_static)
from lcp_physics_tpu_torch.lcp import pdipm
from lcp_physics_tpu_torch.ops import linalg
from lcp_physics_tpu_torch.parallel import make_batched_step, tile_state
from lcp_physics_tpu_torch.utils import SimConfig

DT = 0.01
STEPS = 8     # counted steps per probe, the JAX tool's
# (N, B, c_max, hulls, hull_pair_budget); c_max None is the default 2N
CONFIGS = [(64, 256, None, False, 0), (144, 112, None, False, 0),
           (256, 64, None, False, 0), (256, 64, 448, False, 0),
           (361, 32, 768, False, 0), (144, 112, None, True, 0),
           (144, 112, None, True, 1024), (400, 8, 800, False, 0)]


def build_grid_scene(N, B, dense=True, hulls=False, c_max=None,
                     dtype=torch.float32, device="cuda"):
    """A sqrt(N) x sqrt(N) grid of radius-1 circles (or 2 x 2 squares) at
    spacing 2.01 (2.6 when not ``dense``), jittered by uniform(-0.01,
    0.01), velocities normal(0, 0.5) (numpy seed 1), gravity (0, 10),
    restitution 0.4, c_max = 2N by default; one world tiled B times.
    Returns (static, params, states)."""
    side = int(np.sqrt(N))
    if side * side != N:
        raise ValueError(f"N={N} is not a square")
    rng = np.random.default_rng(1)
    if hulls:
        counts = [4] * N
        sq = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]],
                      np.float32)
        verts = np.broadcast_to(sq, (N, 4, 2)).copy()
        radius = np.zeros(N, np.float32)
    else:
        counts = [1] * N
        verts = np.zeros((N, 1, 2), np.float32)
        radius = np.full(N, 1.0, np.float32)
    static = make_scene_static(counts, c_max=c_max or 2 * N)
    params = default_params(static, verts=verts, radius=radius,
                            gravity=(0.0, 10.0), restitution=0.4,
                            dtype=dtype, device=device)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    spacing = 2.01 if dense else 2.6
    pos = np.stack([gx.ravel() * spacing, gy.ravel() * spacing], -1)
    pos = pos + rng.uniform(-0.01, 0.01, pos.shape)
    v0 = rng.normal(0, 0.5, (N, 3)).astype(np.float32)
    p = np.concatenate([np.zeros((N, 1)), pos], -1).astype(np.float32)
    opts = dict(dtype=dtype, device=device)
    state = WorldState(torch.tensor(p, **opts), torch.tensor(v0, **opts),
                       torch.zeros((), **opts))
    return static, params, tile_state(state, B)


def _counts():
    return dict(linalg.LAUNCHES, library_lu=pdipm.ROUTES["library_lu"])


def _device_busy_ms(fn):
    """Summed device time of fn()'s kernels under torch.profiler, or None
    where the profiler sees no device."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return None
    return sum(e.self_device_time_total for e in ev) / 1e3


def probe(N, B, n_steps, hulls=False, hull_budget=0, c_max=None,
          device="cuda", dtype=torch.float32, config=None):
    """``n_steps`` forward steps of the grid (after one warm-up step) under
    ``config`` (default ``SimConfig(max_iter=12, solver_eps=1e-5,
    hull_pair_budget=hull_budget)``).  Returns a record: N, B, c_max, K2,
    panels T, the factor path read from the counts (the library LU where
    it was routed to, else the blocked LU past ``linalg.MAX_LANE_N`` rows
    or the lane LU), host ms per step (synchronised, profiler
    off), device ms per step (CUDA events around the steps; None off the
    card), busy ms per step (the kernels' summed device time in one more
    step under torch.profiler; None off the card), K4 and K5 launches and
    library-LU routings per step, the probe's seconds on the host clock
    (scene, warm-up and profiler included), and the final state.
    ``panels`` is None off the blocked LU."""
    t_start = time.perf_counter()
    static, params, states = build_grid_scene(N, B, hulls=hulls,
                                              c_max=c_max, dtype=dtype,
                                              device=device)
    C = static.c_max
    K2 = 2 * C + static.n_eq
    config = config or SimConfig(max_iter=12, solver_eps=1e-5,
                                 hull_pair_budget=hull_budget)
    step = make_batched_step(static, config)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def run():
        s = states
        for _ in range(n_steps):
            s, _ = step(params, s, DT)
        return s

    with torch.no_grad():
        step(params, states, DT)                   # warm-up, not counted
        sync()
        before = _counts()
        if cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        t0 = time.perf_counter()
        final = run()
        if cuda:
            b.record()
        sync()
        host_ms = 1e3 * (time.perf_counter() - t0) / n_steps
        after = _counts()
        dev_ms = a.elapsed_time(b) / n_steps if cuda else None
        # one step under the profiler, device events only: processing the
        # host-side events of tens of thousands of launches a step took
        # minutes
        busy_ms = (_device_busy_ms(lambda: step(params, states, DT))
                   if cuda else None)
    per = lambda k: (after[k] - before[k]) / n_steps
    panels = -(-K2 // linalg.PANEL)
    if per("library_lu") > 0:
        panels, path = None, "library LU"
    elif K2 > linalg.MAX_LANE_N:
        path = f"blocked LU, {panels} panels"
    else:
        panels, path = None, "lane LU"
    return dict(N=N, B=B, hulls=hulls, hull_pair_budget=hull_budget,
                c_max=C, K2=K2, panels=panels, path=path, steps=n_steps,
                host_ms=host_ms, device_ms=dev_ms, busy_ms=busy_ms,
                k4_per_step=per("gj_inv_blocked"), k5_per_step=per("gj_inv"),
                library_lu_per_step=per("library_lu"),
                seconds=time.perf_counter() - t_start, final=final)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bigworld: no CUDA device")
    for N, B, c_max, hulls, budget in CONFIGS:
        rec = probe(N, B, STEPS, hulls=hulls, hull_budget=budget,
                    c_max=c_max)
        rec.pop("final")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
