#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lcp_physics_tpu_torch``) on one
NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Device: the card's name and power limit, torch and CUDA versions; builds
   the CUDA kernels from ``lcp_physics_tpu_torch/csrc`` (one nvcc per
   source, all at once) and times the build.
2. Kernels: each kernel (LU factor, substitution, fused IPM rotated (K3)
   and unrotated (K3u, instances without the +- friction pair, fd 2 and
   1), blocked and scalar Gauss-Jordan panel inverse, fused IPM
   iteration) against its plain torch version on the card, float32 and
   float64, at every bucket edge of the fused kernel (K = 16, 17, 24, 25,
   32, 33, 48) and on a ragged batch, with device times of kernel, plain
   version and library call (``cuda_ms``: CUDA events around back-to-back
   calls queued behind a sleep kernel, median of three windows); the panel inverses also by ||K X - I||
   against the plain version's own, at B = 1 and 257 too.  The lane LU
   and its substitution at every bucket edge of ``csrc/lu.cu`` (n = 8,
   9, 16, 17, ..., 64, 65, 88; ``LU_SIZES``), with each bucket kernel's
   registers, spills and shared memory, timed at the forward slice's
   (4096, 16) f32, path (c)'s (4096, 24) f32, ``LCPFunction``'s (256,
   56) f64 and (4096, 88).  The scalar panel kernel (K5) at every bucket
   edge (``GJ_SIZES``, clusters of 1 to 4 CTAs) and on a panel with a
   NaN, with its buckets' registers, spills and shared memory, timed at
   (32, 128, 128) f64 and (256, 128, 128) f32.  K6's registers and
   spills, and K6 on large-n instances.  With ``--parent DIR`` (a checkout of an
   earlier commit), the seven kernels of DIR and of this tree timed in
   turns by ``tools/time_kernels.py``.
3. The forward slice: the batched 8-circle contact rollout of the LCP
   benchmark scene (B = 4096 worlds, c_max = 8, dt = 0.01,
   SimConfig(max_iter=15, solver_eps=1e-6), float32, 20 steps) through
   ``make_batched_step`` and ``rollout`` — once through the kernels, with
   their launch counters reset just before, and once through the plain
   versions — plus a small float64 scene held against the JAX package's
   record (``tests/data/torch_slice_golden.json``).
4. The training slice: value and gradients of mean(p^2) through an 8-step
   rollout of the dense 64-circle grid of bench.py::bench_fwd_bwd_dense
   (B = 256, c_max = 128, SimConfig(max_iter=12, solver_eps=1e-5),
   float32; the rotated Schur system K2 = 256 goes through the blocked
   factor and the rank-16 panel kernel), the same at float64 (B = 32,
   the scalar panel kernel; its device time per step), a B = 2 float64
   grid held against the JAX
   record ``tests/data/torch_train_golden.json``, and the backward of
   bench.py::bench_fwd_bwd's touching 8-circle line (B = 64, 20 steps,
   the trans=1 substitution kernel) — each through the kernels with the
   counters reset just before it, and against the plain versions.
5. Path (b), K6: the dense scene's forward (B = 256 f32, 8 steps) with
   ``lcp.pdipm.FUSE_ITER`` set — per IPM iteration the explicit inverse
   (K4 and ``torch.matmul``) and one launch of the fused per-iteration
   kernel — held to its plain path, timed in turns with the unfused loop,
   with host reads and device events per step.  Before it, in the kernel
   phase, K6 against its plain iteration on the same scene's first-step
   LCP (one iteration at B = 256 f32 and B = 32 f64, runs capped at 3
   iterations, a full f32 run against plain's one-ulp spread), printing
   its launch shape.
6. Path (a), the accuracy profile: the dense training step with
   SimConfig(solver_refine=1) (the explicit-inverse factor with two
   refinement steps per solve, forward and backward), timed in turns with
   refine 0, its capped one-step gradient against plain, the B = 2 f64 JAX
   record ``tests/data/torch_refine_golden.json``, and the first step's
   median final merit at refine 0 and 1.
7. Path (c), the library API on bench.py::bench_lcp_solves' LCPs (the
   forward slice's first step, B = 4096 f32): ``lcp_solve`` with the
   library default ``fric_pair=False`` forward through K3u and backward
   through the unrotated factor's K1/K2 (counters reset just before),
   held to the plain path per world on capped runs and by distribution on
   full ones; the same LCPs rotated, against it at f64 on 256 worlds;
   both timed in turns; ``LCPFunction`` on the dense KKT and
   ``solve_eq_kkt``.  Then ``utils.observe.solver_stats`` on the forward
   slice's scene (K3u) and the dense scene (the unrotated K = 384 through
   K4) against plain, and the f64 JAX record
   ``tests/data/torch_lcp_golden.json`` of ``lcp_solve(fric_pair=False)``
   (regenerate with ``PYTHONPATH=. python
   tests/test_torch_lcp_general.py``).
8. (h) The hull contact step: bench.py::build_world_scene(dense=True,
   hulls=True), built here with numpy from its seed (64 squares of side 2
   in a touching 8 x 8 grid, B = 256 identical worlds, c_max = 128,
   SimConfig(max_iter=12, solver_eps=1e-5), float32, 16 steps), at
   hull_pair_budget 0 and 256: ms/step on the host clock, device ms and
   events per step, host reads and launches per step (K4 must launch: the
   rotated K2 = 256 factor); budget 256 finds budget 0's contacts on the
   first step; the first step against the plain versions by distribution.
9. (p) The same grid at B = 64 with post_stabilization, then with the
   penetration backtrack (halvings, the backtrack's host reads); the f64
   hull scene (a Rect, a pentagon, circles, a joint; B = 4, 4 steps, both
   options on) against the JAX record tests/data/torch_hull_golden.json
   (regenerate with ``PYTHONPATH=. python tests/test_torch_hull.py``).
10. (w) The object layer on the card: hello_world and chain for 60
   World.step calls each (ms per World.step, counters moved, host
   reads), three Adam steps of the inference demo (its loss falls), and
   World.broadphase_pairs through the C++ sweep-and-prune.
11. (s) Worlds sharded over ``parallel.make_mesh()`` (the card) and over
   the card listed twice, [cuda:0, cuda:0] (a worker thread and a stream
   per entry): the forward slice's rollout (B = 4096 f32, 20 steps) held
   bit for bit to the unsharded step at batch_tile = B / shards, K1, K2
   and K3 launched, host ms/step in turns with the unsharded step (and
   with the two shards stepped by one thread), device events and ms per
   step; the dense training step (B = 256 f32, 8 steps) over [cuda:0,
   cuda:0], its loss bit for bit and its shared-parameter gradients
   against the tiled step's, K4 launched; the sharded inference demo at
   its defaults (256 worlds, 60 epochs; the mass within 0.3), then three
   epochs on each mesh against each other; ``entry()`` and
   ``dryrun_multichip(1)`` against ``(2, [cuda:0, cuda:0])``, contact-free
   scenes that launch no solver kernel.
12. (v) The f32 physics-quality guard (``lcp_physics_tpu_torch.tools.
   validate_f32``) at full length at both profiles (production and
   solver_refine=2): the dense grid's penetration over 500 steps, the
   free cluster's momentum over 200, the box stack over 300, the bounce
   law over 500; each value printed, all 8 must pass at the JAX tool's
   thresholds, and each scene must launch its kernels (K3 for the bounce,
   K1/K2 for the stack, K4 for the cluster and the grid).  With
   ``--grid-hold`` the script runs only phase 1 and the production dense
   grid held against float32 chaos: through the kernels at p and at
   p + 1 ulp, through the plain versions at both (~15 min).
13. (g) Big single worlds (``lcp_physics_tpu_torch.tools.bigworld``): the
   dense grid at N = 64, 144, 256 and 361 bodies (K2 up to 1536, 12
   panels), the hull grid at N = 144 with hull_pair_budget 0 and 1024,
   and N = 400 at c_max = 800 (K2 = 1600, past the blocked cap, through
   the library LU), 8 f32 steps each: host ms, device ms (events) and
   busy ms (profiler) per step, K4 launches and library-LU routings per
   step; the 12-panel path held to the plain versions at f64 (B = 2, one
   capped step, K5) and f32 (B = 32, by distribution).
14. The card's name and power limit, a JSON line listing every kernel
   (``ms``, ``plain_ms``, ``library_ms`` — one PyTorch call computing the
   same function where there is one, timed here only —, ``bound_ms`` and
   ``bound_by`` from the call's bytes and operations at the card's
   published peaks, launches on its path plus those of (v) and (g)),
   then the contract line
   ``{"ok": true, "device": {...}}`` last.

Any failed check raises; the script exits non-zero without the last line.
It exits non-zero at once when no CUDA device is present.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 4096
N, C, DT, STEPS = 8, 8, 0.01, 20
CAP_ITERS = 3   # the fused kernel's per-world check: iterations, no stopping
TRAIN_B, TRAIN_SIDE, TRAIN_C, TRAIN_STEPS = 256, 8, 128, 8
TRAIN_B64 = 32
GJ_RES_RATIO = 4   # a panel kernel's ||K X - I|| against its plain version's
LINE_B, LINE_STEPS = 64, 20
ITER_B64 = 32   # K6 at float64: worlds of the dense scene
HULL_B, HULL_STEPS, HULL_C = 256, 16, 128   # bench.py's dense hull grid
STAB_B, STAB_STEPS = 64, 8
WORLD_STEPS, INFER_EPOCHS = 60, 3
# The H100 SXM's published peaks (NVIDIA's data sheet; full 700 W power
# limit): HBM3 bytes/s, and the highest FLOP/s for each item size without
# reduced precision: float32 outside the tensor cores, float64 on them.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")
    print(f"  ok: {what}", flush=True)


def bound(nbytes, flops, itemsize):
    """The least time the card could take for a call that must move
    ``nbytes`` (each input read once, each output written once) and do
    ``flops`` operations of ``itemsize``-byte floats: bound_ms and what
    bounds it."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[itemsize]
    return dict(bound_ms=1e3 * max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(torch, fn, runs=3, calls=20, window_ms=1.0):
    """Device time of one fn() call in ms: after a warm-up, CUDA events
    around ``calls`` back-to-back calls (more if needed to pass
    ``window_ms``), divided by the count; the median of ``runs`` such
    windows.  Each window follows a sleep kernel long enough for the host
    to enqueue the whole window, so the card runs the calls back to back
    and the wrapper's host work stays out of the time (a function that
    waits on the card itself, as the plain loops do, is timed with its
    host work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    calls = max(calls, int(np.ceil(window_ms / max(a.elapsed_time(b), 1e-3))))
    # ~2e9 cycles per second; at most 50 ms of sleep
    sleep = int(min(2e9 * 1.5 * calls * host_s, 1e8))
    times = []
    for _ in range(runs):
        torch.cuda._sleep(sleep)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def kkt_batch(rng, B, n):
    """Quasi-definite KKT matrices [[Q, G^T], [G, -D]], the class the
    interior-point solver factors (numpy, float64)."""
    nq = (n + 1) // 2
    m = n - nq
    L = rng.standard_normal((B, nq, nq))
    K = np.zeros((B, n, n))
    K[:, :nq, :nq] = L @ L.transpose(0, 2, 1) + nq * np.eye(nq)
    G = rng.standard_normal((B, m, nq))
    K[:, nq:, :nq] = G
    K[:, :nq, nq:] = G.transpose(0, 2, 1)
    K[:, nq:, nq:] = -np.eye(m) * rng.uniform(0.1, 10.0, (B, m, 1))
    return K


def engine_instance(rng, B, n, C, q, valid_frac=0.7, pair=True, fd=2):
    """Engine-layout contact LCPs (the generator of tests/test_fused_ipm.py,
    numpy only): with ``pair`` the +-friction pair structure (fd = 2),
    without it ``fd`` independent friction rows per contact."""
    qd = rng.uniform(0.5, 2.0, (B, n))
    p = rng.standard_normal((B, n))
    valid = (rng.random((B, C)) < valid_frac).astype(float)
    mu = rng.uniform(0.3, 1.0, (B, C)) * valid
    Jc = rng.standard_normal((B, C, n)) * valid[..., None]
    if pair:
        fd = 2
        Jf1 = rng.standard_normal((B, C, n)) * valid[..., None]
        Jf = np.concatenate([Jf1, -Jf1], 1)
    else:
        Jf = rng.standard_normal((B, fd * C, n)) \
            * np.tile(valid, (1, fd))[..., None]
    G = np.concatenate([-Jc, -Jf, np.zeros((B, C, n))], 1)
    jcv = np.einsum("bcn,bn->bc", Jc, p)
    h = np.concatenate([np.where(valid > 0, 0.3 * jcv, 1.0),
                        np.where(np.tile(valid, (1, fd)) > 0, 0.0, 1.0),
                        np.where(valid > 0, 0.0, 1.0)], -1)
    rmask = np.concatenate([valid, np.tile(valid, (1, fd)), valid], -1)
    A = rng.standard_normal((B, q, n))
    b = np.einsum("bqn,bn->bq", A, rng.standard_normal((B, n))) * 0.1
    return qd, p, G, h, A, b, mu, valid, rmask


def world_rel(a, r):
    """Per-world ||a - r||_inf / ||r||_inf (leading axis = worlds)."""
    a = a.double().reshape(a.shape[0], -1)
    r = r.double().reshape(r.shape[0], -1)
    return (a - r).abs().amax(-1) / r.abs().amax(-1).clamp_min(1e-300)


def share(e, lim):
    """Share of worlds whose error e is at most lim."""
    return float((e <= lim).double().mean())


def rel_err(a, r):
    """Largest per-world ||a - r||_inf / ||r||_inf."""
    return float(world_rel(a, r).max())


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls run in full float32 (TF32 off)")
    from lcp_physics_tpu_torch.ops import _build
    t0 = time.time()
    names = _build.load_all()
    print(f"kernels built and loaded in {time.time() - t0:.1f} s: "
          f"{', '.join(names)}", flush=True)
    return smi


# K1/K2 sizes: every bucket edge of csrc/lu.cu (NB and NB + 1) and the
# paths' 16 (forward slice), 24 (path (c)) and 56 (LCPFunction's KKT)
LU_SIZES = (8, 9, 16, 17, 24, 25, 32, 33, 48, 49, 56, 64, 65, 88)
# (label, worlds, n, f64) of the timed K1/K2 shapes; the first is the row
# of the kernel table
LU_TIMED = (("forward slice", B, 16, False), ("path (c)", B, 24, False),
            ("LCPFunction", 256, 56, True), ("n = 88", B, 88, False),
            ("n = 88", B, 88, True))


def lu_attrs(torch):
    """Registers and local (spill) bytes a thread, and static shared bytes
    a CTA, of every K1/K2 bucket kernel (K2 for trans 0 and 1); the shared
    bytes held to ``linalg.lane_shape``'s count."""
    import ctypes
    from lcp_physics_tpu_torch.ops import linalg
    lib = linalg._lu_lib()
    out = (ctypes.c_int * 3)()
    for kind, name in ((0, "K1"), (1, "K2"), (2, "K2 trans=1")):
        for f64 in (0, 1):
            row = []
            for nb in linalg.LANE_BUCKETS:
                linalg._build.check(lib, lib.lcp_lu_attrs(kind, f64, nb, out),
                                    "lcp_lu_attrs")
                regs, local, shared = out
                want = linalg.lane_shape(nb, 8 if f64 else 4, kind > 0).smem
                check(shared == want, f"{name} bucket {nb} "
                      f"{'f64' if f64 else 'f32'}: {shared} B of static "
                      f"shared memory, as lane_shape counts ({want})")
                row.append(f"{nb}: {regs} regs, {local} B local")
            print(f"  {name} {'f64' if f64 else 'f32'} buckets: "
                  + "; ".join(row), flush=True)


def lu_times(torch, K, r):
    """Device times of K1 and K2 (trans 0 and 1) on (K, r) beside the
    plain versions, the library calls (``lu_factor(pivot=False)``,
    ``lu_solve``) and the bounds: {"lu": ..., "solve": ..., "solve_t":
    ...}."""
    from lcp_physics_tpu_torch.ops import linalg
    Bn, n = r.shape
    item = K.element_size()
    lu = linalg.plu_factor(K)
    lu_ref = linalg.plu_factor_ref(K)
    lu_l, piv = torch.linalg.lu_factor(K, pivot=False)
    out = dict(lu=dict(
        max_abs_err=float((lu - lu_ref).abs().max()),
        ms=cuda_ms(torch, lambda: linalg.plu_factor(K)),
        plain_ms=cuda_ms(torch, lambda: linalg.plu_factor_ref(K)),
        library_ms=cuda_ms(torch, lambda: torch.linalg.lu_factor(
            K, pivot=False)),
        **bound(2 * nbytes(K), Bn * 2 * n ** 3 / 3, item)))
    for trans, key in ((0, "solve"), (1, "solve_t")):
        x = linalg.plu_solve(lu, r, trans)
        x_ref = linalg.plu_solve_ref(lu, r, trans)
        out[key] = dict(
            max_abs_err=float((x - x_ref).abs().max()),
            ms=cuda_ms(torch, lambda: linalg.plu_solve(lu, r, trans)),
            plain_ms=cuda_ms(torch,
                             lambda: linalg.plu_solve_ref(lu, r, trans)),
            library_ms=cuda_ms(torch, lambda: torch.linalg.lu_solve(
                lu_l, piv, r[..., None], adjoint=bool(trans))),
            **bound(nbytes(lu, r, x), Bn * 2 * n * n, item))
    return out


def phase_lu(torch, dev):
    """K1 and K2 against their plain versions at every size of LU_SIZES,
    B = 4096, f32 and f64 (the factor bit for bit; the substitution at f64
    per call 1e-8, at f32 by residual 1e-4), the
    bucket kernels' registers and spills, then device times at LU_TIMED.
    Returns the kernel rows of the forward slice's shape."""
    from lcp_physics_tpu_torch.ops import linalg
    lu_attrs(torch)
    rng = np.random.default_rng(0)
    for n in LU_SIZES:
        Kn = kkt_batch(rng, B, n)
        rn = rng.standard_normal((B, n))
        for dt in (torch.float32, torch.float64):
            K = torch.tensor(Kn, dtype=dt, device=dev)
            r = torch.tensor(rn, dtype=dt, device=dev)
            lu = linalg.plu_factor(K)
            lu_ref = linalg.plu_factor_ref(K)
            torch.cuda.synchronize()
            tag = f"n={n} {str(dt)[6:]}"
            check(torch.equal(lu, lu_ref),
                  f"lu {tag}: the factor is plain's bit for bit")
            for trans in (0, 1):
                x = linalg.plu_solve(lu, r, trans)
                x_ref = linalg.plu_solve_ref(lu_ref, r, trans)
                torch.cuda.synchronize()
                if dt == torch.float64:
                    e = rel_err(x, x_ref)
                    check(e <= 1e-8, f"solve {tag} trans={trans}: "
                                     f"vs plain {e:.2e}")
                else:
                    Kd = K.double() if trans == 0 else K.double().transpose(1, 2)
                    res = torch.einsum("bij,bj->bi", Kd, x.double()) - r.double()
                    e = float((res.abs().amax(-1)
                               / r.double().abs().amax(-1)).max())
                    check(e <= 1e-4, f"solve {tag} trans={trans}: "
                                     f"residual {e:.2e}")
    out = {}
    for label, Bn, n, f64 in LU_TIMED:
        dt = torch.float64 if f64 else torch.float32
        K = torch.tensor(kkt_batch(rng, Bn, n), dtype=dt, device=dev)
        r = torch.tensor(rng.standard_normal((Bn, n)), dtype=dt, device=dev)
        times = lu_times(torch, K, r)
        for k, t in times.items():
            print(f"  {k} ({Bn}, {n}) {str(dt)[6:]}, {label}: {t['ms']:.4f} "
                  f"ms (plain {t['plain_ms']:.3f}, library "
                  f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} ms by "
                  f"{t['bound_by']})", flush=True)
        out = out or times
    return {k: out[k] for k in ("lu", "solve")}


def inv_residual(torch, K, X):
    """Per-matrix ||K X - I||_inf (largest entry), in float64."""
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (K.double() @ X.double() - eye).abs().amax((1, 2))


def hold_gj(torch, name, f, fr, K):
    """One panel-inverse kernel against its plain version on panels K: the
    per-matrix error (f32 1e-4, f64 1e-10), and ||K X - I||_inf at most
    GJ_RES_RATIO times plain's, in the largest and in the median matrix
    (a fault at rounding level, such as D^-1 D's noise left in K4's pivot
    column, passes the error bound but not this).  Returns (X, Xr)."""
    X, Xr = f(K), fr(K)
    torch.cuda.synchronize()
    e = rel_err(X, Xr)
    res, res_r = inv_residual(torch, K, X), inv_residual(torch, K, Xr)
    rmax, rmax_r = float(res.max()), float(res_r.max())
    rmed, rmed_r = float(res.median()), float(res_r.median())
    lim = 1e-4 if K.dtype == torch.float32 else 1e-10
    B, P = K.shape[:2]
    check(e <= lim and rmax <= GJ_RES_RATIO * rmax_r
          and rmed <= GJ_RES_RATIO * rmed_r,
          f"{name} ({B}, {P}, {P}) {str(K.dtype)[6:]}: per-matrix error vs "
          f"plain {e:.2e} (<= {lim:g}); ||K X - I||_inf max {rmax:.2e}, "
          f"median {rmed:.2e} (plain {rmax_r:.2e}, {rmed_r:.2e}; <= "
          f"{GJ_RES_RATIO}x); {cuda_ms(torch, lambda: f(K)):.3f} ms vs "
          f"plain {cuda_ms(torch, lambda: fr(K)):.3f} ms")
    return X, Xr


# K5's sizes: every bucket edge of its scalar kernel (32, 64, 96, 128) and
# the tests' 40
GJ_SIZES = (1, 31, 32, 33, 40, 64, 65, 96, 97, 128)


def gj_attrs(torch):
    """Registers and local (spill) bytes a thread of K5's bucket kernels,
    and their shared bytes a CTA held to ``linalg.gj_shape``'s count."""
    import ctypes
    from lcp_physics_tpu_torch.ops import linalg
    lib = linalg._gj_lib()
    out = (ctypes.c_int * 3)()
    for f64 in (0, 1):
        row = []
        for pb in linalg.GJ_BUCKETS:
            linalg._build.check(lib, lib.lcp_gj_inv_attrs(f64, pb, out),
                                "lcp_gj_inv_attrs")
            regs, local, shared = out
            want = linalg.gj_shape(pb, 8 if f64 else 4).smem
            check(shared == want, f"K5 bucket {pb} {'f64' if f64 else 'f32'}"
                  f": {shared} B of shared memory a CTA, as gj_shape counts "
                  f"({want})")
            row.append(f"{pb}: {regs} regs, {local} B local")
        print(f"  K5 {'f64' if f64 else 'f32'} buckets: " + "; ".join(row),
              flush=True)


def gj_times(torch, name, f, fr, K):
    """Device times of a panel kernel beside its plain version, the library
    inverse and the bound on panels K."""
    Bp, P = K.shape[:2]
    X, Xr = f(K), fr(K)
    return dict(max_abs_err=float((X - Xr).abs().max()),
                ms=cuda_ms(torch, lambda: f(K)),
                plain_ms=cuda_ms(torch, lambda: fr(K)),
                library_ms=cuda_ms(torch, lambda: torch.linalg.inv(K)),
                **bound(2 * nbytes(K), Bp * 2 * P ** 3, K.element_size()))


def phase_gj(torch, dev):
    """K4 (rank-16 blocked, f32) and K5 (scalar, f32 and f64) against their
    plain versions on quasi-definite panels, B = 1024, K5 at every size of
    GJ_SIZES (B = 33, f32 and f64: clusters of 1 to 4 CTAs) and on a panel
    with a NaN, then at the training paths' shapes: K4 on (256, 64, 64) f32
    panels (the dense f32 step's two-level split), K5 on (32, 128, 128) f64
    (the f64 step) and on (256, 128, 128) f32 (``exact``, the f32 factor
    under solver_factor_precision='highest')."""
    from lcp_physics_tpu_torch.ops import linalg
    gj_attrs(torch)
    rng = np.random.default_rng(0)
    kinds = {"gj_inv_blocked": (linalg.gj_inv_blocked,
                                linalg.gj_inv_blocked_ref),
             "gj_inv": (linalg.gj_inv, linalg.gj_inv_ref)}
    for P in (64, 128):
        Kn = kkt_batch(rng, 1024, P)
        for dt in (torch.float32, torch.float64):
            K = torch.tensor(Kn, dtype=dt, device=dev)
            names = (["gj_inv_blocked"] if dt == torch.float32 else []) \
                + (["gj_inv"] if P == 128 else [])
            for name in names:
                hold_gj(torch, name, *kinds[name], K)
    for P in (16, 48, 64, 128):      # K4's edges: one panel, a ragged grid
        for Bp in (1, 257):
            K = torch.tensor(kkt_batch(rng, Bp, P), dtype=torch.float32,
                             device=dev)
            hold_gj(torch, "gj_inv_blocked", *kinds["gj_inv_blocked"], K)
    for P in GJ_SIZES:
        Kn = kkt_batch(rng, 33, P)
        for dt in (torch.float32, torch.float64):
            hold_gj(torch, "gj_inv", *kinds["gj_inv"],
                    torch.tensor(Kn, dtype=dt, device=dev))
    K = torch.tensor(kkt_batch(rng, 3, 128), device=dev)
    K[1, 5, 7] = float("nan")
    X, Xr = linalg.gj_inv(K), linalg.gj_inv_ref(K)
    check(torch.equal(torch.isfinite(X), torch.isfinite(Xr))
          and bool(torch.isfinite(X[0]).all() and torch.isfinite(X[2]).all()),
          "K5 with a NaN in one of 3 panels: non-finite where plain's is, "
          "the other panels finite")
    out = {}
    for name, Bp, P, dt in (("gj_inv_blocked", TRAIN_B, 64, torch.float32),
                            ("gj_inv", TRAIN_B64, 128, torch.float64),
                            ("gj_inv f32", TRAIN_B, 128, torch.float32)):
        f, fr = kinds[name.split()[0]]
        K = torch.tensor(kkt_batch(rng, Bp, P), dtype=dt, device=dev)
        hold_gj(torch, name.split()[0], f, fr, K)
        out[name] = t = gj_times(torch, name, f, fr, K)
        print(f"  {name} ({Bp}, {P}, {P}) {str(dt)[6:]}: {t['ms']:.4f} ms "
              f"(plain {t['plain_ms']:.3f}, library {t['library_ms']:.4f}, "
              f"bound {t['bound_ms']:.4f} ms by {t['bound_by']})", flush=True)
    return out


def ulp_tensor(torch, x):
    """x moved by about one ulp of float32 (torch generator, seed 1)."""
    return x * (1 + 2.0 ** -23 * torch.randn(
        x.shape, generator=torch.Generator(x.device).manual_seed(1),
        device=x.device, dtype=x.dtype))


def hold_full_f32(torch, tag, got, ref, pert):
    """A float32 full solve (z, s, lam, nu, mu, resid, iters) against its
    plain version ``ref``: f32 stops on a merit near its f32 floor, where
    one ulp of input moves the stopping iteration and z, so the plain
    version at p + 1 ulp (``pert``) is the yardstick for the shares."""
    same = got[6] == ref[6]
    ez = world_rel(got[0], ref[0])[same]
    el = world_rel(got[2], ref[2])[same]
    frac = float(same.double().mean())
    frac_ulp = float((pert[6] == ref[6]).double().mean())
    check(frac >= 0.9 * frac_ulp
          and share(ez, 1e-4) >= 0.999
          and float(ez.median()) <= 1e-6
          and float(el.median()) <= 1e-4,
          f"{tag}: iterations equal on {frac:.2%} of "
          f"worlds (plain at p+1ulp: {frac_ulp:.2%}); on those "
          f"z within 1e-4 on {share(ez, 1e-4):.2%}, median z "
          f"{float(ez.median()):.2e} (<= 1e-6), lam "
          f"{float(el.median()):.2e} (<= 1e-4)")
    merit_ref = ref[4] + ref[5]
    worse = float((got[4] + got[5] - merit_ref).max())
    worse_ulp = float((pert[4] + pert[5] - merit_ref).max())

    def agree(x, y):
        e = (x[0] - y[0]).abs().amax(-1) / \
            y[0].abs().amax(-1).clamp_min(1.0)
        return share(e, 1e-3)
    frac, frac_ulp = agree(got, ref), agree(pert, ref)
    check(worse <= 1e-3 and frac >= frac_ulp - 0.01,
          f"{tag}: merit at most {worse:.2e} above plain "
          f"(plain at p+1ulp: {worse_ulp:.2e}; bound 1e-3), z "
          f"within 1e-3 of plain on {frac:.2%} of worlds "
          f"(plain at p+1ulp: {frac_ulp:.2%})")


# (C, q, fd, dtypes) of the fused-kernel phase: the rotated variant (K3)
# at K = 2C + q, the unrotated one (K3u) at K = (1 + fd)C + q, at and past
# each of the kernel's buckets (16, 24, 32, 48); the path's shape first
FUSED_SHAPES = {
    True: [(Cc, q, 2, ("float32", "float64"))
           for Cc, q in ((8, 0), (8, 1), (8, 3), (12, 0), (12, 1), (16, 0),
                         (16, 1), (16, 3), (24, 0))],
    False: [(Cc, q, 2, ("float32", "float64"))
            for Cc, q in ((8, 0), (5, 1), (8, 1), (8, 3), (11, 0), (12, 0),
                          (16, 0))]
    + [(16, 0, 1, ("float64",)), (8, 1, 1, ("float64",))]}


def phase_fused(torch, dev, rot=True):
    """The fused whole-IPM kernel against its plain loop at B = 4096, n = 24:
    K3 (``rot``, instances with the +- friction pair) or K3u (instances
    without it), per world on runs capped at CAP_ITERS iterations, and the
    full runs; times at (C, q) = (C, 0) float32."""
    from lcp_physics_tpu_torch.lcp.cone import ConeF
    from lcp_physics_tpu_torch.lcp.pdipm import _dtype_consts, initial_point
    from lcp_physics_tpu_torch.ops import ipm
    rng = np.random.default_rng(0 if rot else 1)
    n = 3 * N
    name = "fused_ipm" if rot else "fused_ipm_unrot"
    out = {}
    for Cc, q, fd, dts in FUSED_SHAPES[rot]:
        inst = engine_instance(rng, B, n, Cc, q, pair=rot, fd=fd)
        for dt in (getattr(torch, d) for d in dts):
            qd, p, G, h, A, b, mu, valid, rmask = (
                torch.tensor(x, dtype=dt, device=dev) for x in inst)
            consts = _dtype_consts(dt)
            ops = (ipm.rot_operands if rot else ipm.unrot_operands)(
                qd, G, A, Cc)
            x0 = initial_point(ops, p, h, b, ConeF(mu, valid, fd), rmask,
                               consts, fric_pair=rot)
            f64 = dt == torch.float64
            args = (ops, p, h, b, mu, valid, rmask, *x0)
            K = 2 * Cc + q if rot else (1 + fd) * Cc + q
            tag = (f"{name} C={Cc} q={q} fd={fd} K={K} {str(dt)[6:]}")
            base = dict(C=Cc, fd=fd, consts=consts, fric_pair=rot)
            KB, W, ghat = ipm.launch_shape(n, h.shape[1], q,
                                           Cc, K, p.element_size())
            need = ipm._lib().lcp_fused_ipm_smem_bytes(
                n, h.shape[1], q, Cc, fd, int(rot), int(f64), KB, ghat)
            check(ipm.smem_bytes(n, h.shape[1], q, Cc, K, KB,
                                 p.element_size(), ghat) == need,
                  f"{tag}: the wrapper's shared-memory count equals the "
                  f"kernel's ({need} B per world, bucket {KB}, {W} worlds "
                  f"per CTA, Ghat in shared memory: {bool(ghat)})")

            # Capped: no stopping rule fires, every world runs CAP_ITERS
            # iterations of the loop, still well conditioned -- per world.
            cap = dict(base, max_iter=CAP_ITERS, tol=0.0, not_improved_lim=0)
            got = ipm.fused_ipm(*args, **cap)
            ref = ipm.fused_ipm_ref(*args, **cap)
            ez, el = world_rel(got[0], ref[0]), world_rel(got[2], ref[2])
            lim = 1e-8 if f64 else 1e-3
            check(float(torch.maximum(ez, el).max()) <= lim
                  and float(ez.median()) <= lim / 100,
                  f"{tag}, {CAP_ITERS} iterations on every world: z "
                  f"{float(ez.max()):.2e} (median {float(ez.median()):.2e}),"
                  f" lam {float(el.max()):.2e} vs plain (<= {lim:g}, "
                  f"median <= {lim / 100:g})")
            # a ragged batch (no multiple of the worlds per CTA): its worlds
            # give the batch's results bit for bit
            Br = B - 3
            cut = [tuple(x[:Br] for x in a) if isinstance(a, tuple)
                   else a[:Br] for a in args]
            part = ipm.fused_ipm(*cut, **cap)
            check(all(torch.equal(g, r[:Br]) for g, r in zip(part, got)),
                  f"{tag}, capped, the first {Br} worlds alone: the same "
                  f"results bit for bit")

            # Full: the solver's own stopping rules.
            kw = dict(base, max_iter=25 if f64 else 15,
                      tol=1e-8 if f64 else 1e-6,
                      not_improved_lim=3 if f64 else 1)
            got = ipm.fused_ipm(*args, **kw)
            ref = ipm.fused_ipm_ref(*args, **kw)
            if f64:
                # Same algorithm: worlds that took the same iteration path
                # agree to 1e-8; a world whose merit lands on the tol
                # boundary may stop one iteration apart (<= 0.1%).
                same = got[6] == ref[6]
                ez = world_rel(got[0], ref[0])[same]
                el = world_rel(got[2], ref[2])[same]
                frac = float(same.double().mean())
                check(float(ez.max()) <= 1e-8 and float(el.max()) <= 1e-8
                      and frac >= 0.999,
                      f"{tag}: iterations equal on {frac:.3%} of "
                      f"worlds; on those z {float(ez.max()):.2e}, lam "
                      f"{float(el.max()):.2e} vs plain")
            else:
                pert = ipm.fused_ipm_ref(ops, ulp_tensor(torch, p),
                                         *args[2:], **kw)
                hold_full_f32(torch, tag, got, ref, pert)
                if Cc == C and q == 0:       # the slice's shape
                    out[name] = dict(
                        max_abs_err=float((got[0] - ref[0]).abs().max()),
                        ms=cuda_ms(torch, lambda: ipm.fused_ipm(*args, **kw)),
                        plain_ms=cuda_ms(
                            torch, lambda: ipm.fused_ipm_ref(*args, **kw)),
                        library_ms=None,
                        **fused_bound(ops, args, got, n, K))
    return out


def fused_bound(ops, args, got, n, K):
    """K3's (or K3u's) bound for this run, K the Schur system's rows: its
    inputs and outputs once, and per world the iterations it ran (iters; a
    world stops before the factor of its last one): a K x K Gauss-Jordan
    inverse (2K^3), two solves of three K x K matvecs (12K^2) and two Ghat
    products (4Kn) each, and two more Ghat products per merit evaluation
    (iters + 3 of them)."""
    it = got[6].double()
    flops = float((it * (2 * K ** 3 + 12 * K * K + 4 * K * n)
                   + (it + 3) * 4 * K * n).sum())
    return bound(nbytes(*ops, *args[1:], *got), flops, got[0].element_size())


def launch_counts():
    from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
    return dict(linalg.LAUNCHES, **ipm.LAUNCHES, **ipm_iter.LAUNCHES)


def reset_counts():
    from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
    for counts in (linalg.LAUNCHES, ipm.LAUNCHES, ipm_iter.LAUNCHES):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def plain_kernels(what):
    """Route the solver through the plain torch versions (the comparison
    path): the solver looks its kernels up on these modules.  Checks that
    no kernel launched inside, so the comparison path was plain."""
    from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
    swaps = [(linalg, "lu_factor", linalg.plu_factor_ref),
             (linalg, "lu_solve", linalg.plu_solve_ref),
             (linalg, "gj_inv_blocked", linalg.gj_inv_blocked_ref),
             (linalg, "gj_inv", linalg.gj_inv_ref),
             (ipm, "fused_ipm", ipm.fused_ipm_ref),
             (ipm_iter, "fused_iter_ipm", ipm_iter.fused_iter_ipm_ref)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, ref in swaps:
        setattr(mod, name, ref)
    before = launch_counts()
    try:
        yield
    finally:
        for (mod, name, _), f in zip(swaps, saved):
            setattr(mod, name, f)
    check(launch_counts() == before,
          f"{what} launched no kernel (plain versions only)")


def slice_start(B):
    """The benchmark scene's start (numpy, seed 0): per world 8 circles at
    positions uniform(0, 5) with angle 0, velocities standard normal."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 5.0, (B, N, 2))
    p0 = np.concatenate([np.zeros((B, N, 1)), pos], -1)
    return p0, rng.standard_normal((B, N, 3))


def slice_scene(torch, dev, dt, p0, v0):
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static)
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    static = make_scene_static([1] * N, c_max=C)
    params = default_params(static, verts=np.zeros((N, 1, 2)),
                            radius=np.full(N, 1.0), gravity=(0.0, 10.0),
                            restitution=0.4, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(p0.shape[0], dtype=dt, device=dev))
    step = make_batched_step(static, SimConfig(max_iter=15, solver_eps=1e-6))
    return step, params, state


def grid_start(B, side, seed=1):
    """The touching grid of bench.py::build_world_scene(dense=True):
    side x side radius-1 circles at spacing 2.01, positions jittered by
    uniform(-0.01, 0.01), velocities normal(0, 0.5), drawn per world
    (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([gx.ravel() * 2.01, gy.ravel() * 2.01], -1)
    pos = pos + rng.uniform(-0.01, 0.01, (B, side * side, 2))
    v0 = rng.normal(0, 0.5, (B, side * side, 3))
    return np.concatenate([np.zeros((B, side * side, 1)), pos], -1), v0


def line_start(B):
    """bench.py::bench_fwd_bwd's touching line: 8 radius-1 circles at
    spacing 2.0 on the x axis, at rest, in every world."""
    pos = np.stack([np.arange(8) * 2.0, np.zeros(8)], -1)
    p0 = np.concatenate([np.zeros((8, 1)), pos], -1)
    return np.broadcast_to(p0, (B, 8, 3)).copy(), np.zeros((B, 8, 3))


def train_scene(torch, dev, dt, p0, v0, c_max, restitution=0.4, **cfg):
    """(step, params, state) of a circle scene under the benchmark's
    training configuration, SimConfig(max_iter=12, solver_eps=1e-5)
    (``cfg`` adds or replaces fields), gravity (0, 10); params.mass,
    .restitution,
    .fric_coeff and state.v require gradients."""
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static)
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    n = p0.shape[1]
    static = make_scene_static([1] * n, c_max=c_max)
    params = default_params(static, verts=np.zeros((n, 1, 2)),
                            radius=np.full(n, 1.0), gravity=(0.0, 10.0),
                            restitution=restitution, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(p0.shape[0], dtype=dt, device=dev))
    for x in (params.mass, params.restitution, params.fric_coeff, state.v):
        x.requires_grad_(True)
    step = make_batched_step(static, SimConfig(
        **dict(dict(max_iter=12, solver_eps=1e-5), **cfg)))
    return step, params, state


def train_step(torch, step, params, state, n_steps, remat=False):
    """Loss mean(p^2) after an ``n_steps`` rollout and its gradients with
    respect to (mass, restitution, fric_coeff, v0)."""
    from lcp_physics_tpu_torch.core import rollout
    final, _ = rollout(step, params, state, DT, n_steps, remat=remat)
    loss = (final.p ** 2).mean()
    leaves = (params.mass, params.restitution, params.fric_coeff, state.v)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def timed_rollout(torch, step, params, state, n):
    from lcp_physics_tpu_torch.core import rollout
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, traj = rollout(step, params, state, DT, n)
    torch.cuda.synchronize()
    return final, traj, time.perf_counter() - t0


def phase_slice(torch, dev, smi):
    from lcp_physics_tpu_torch.ops import ipm, linalg
    p0, v0 = slice_start(B)
    step, params, state = slice_scene(torch, dev, torch.float32, p0, v0)
    step(params, state, DT)                        # warm-up, not counted
    reset_counts()
    final, traj, sec = timed_rollout(torch, step, params, state, STEPS)
    launches = launch_counts()
    print(f"slice launches over {STEPS} steps: {launches}", flush=True)
    check(all(launches[k] > 0 for k in ("lu", "solve", "fused_ipm")),
          "the rollout launched the lu, solve and fused_ipm kernels")
    check(bool(torch.isfinite(traj.p).all() and torch.isfinite(traj.v).all()),
          "every state of the kernel rollout is finite")
    with plain_kernels("the f32 comparison rollouts"):
        _, traj_ref, sec_ref = timed_rollout(torch, step, params, state,
                                             STEPS)
        # The f32 rollout's own sensitivity: the plain path from p0 moved
        # by about one ulp.  Some of 4096 worlds always sit at a discrete
        # threshold (contact activation, stall exit), so kernel vs plain
        # is held to this, not to a per-world maximum.
        p_ulp = p0 * (1 + 2.0 ** -23
                      * np.random.default_rng(1).standard_normal(p0.shape))
        _, params_u, state_u = slice_scene(torch, dev, torch.float32,
                                           p_ulp, v0)
        _, traj_ulp, _ = timed_rollout(torch, step, params_u, state_u,
                                       STEPS)
    e1, e1_ulp = (world_rel(t.v[0], traj_ref.v[0]) for t in (traj, traj_ulp))
    med = float(e1.median())
    check(med <= 1e-5 and share(e1, 1e-3) >= share(e1_ulp, 1e-3) - 0.01,
          f"one-step v kernel vs plain, f32: median world {med:.2e} "
          f"(<= 1e-5), within 1e-3 on {share(e1, 1e-3):.2%} of worlds "
          f"(plain at p+1ulp: {share(e1_ulp, 1e-3):.2%}, median "
          f"{float(e1_ulp.median()):.2e})")
    d, d_ulp = ((t.p - traj_ref.p).abs().amax(dim=(0, 2, 3))
                for t in (traj, traj_ulp))
    drift = float(d.max())
    check(share(d, 0.05) >= share(d_ulp, 0.05) - 0.001,
          f"{STEPS}-step drift kernel vs plain under 0.05 on "
          f"{share(d, 0.05):.3%} of worlds, max {drift:.3e}, median "
          f"{float(d.median()):.2e} (plain at p+1ulp: "
          f"{share(d_ulp, 0.05):.3%}, max {float(d_ulp.max()):.3e})")
    for s, path in ((sec, "kernel"), (sec_ref, "plain")):
        print(f"slice {path} path: {1e3 * s / STEPS:.3f} ms/step, "
              f"{B * STEPS / s:,.0f} world-steps/s "
              f"(B={B}, f32, {STEPS} steps; {smi})", flush=True)

    step64, params64, state64 = slice_scene(torch, dev, torch.float64, p0,
                                            v0)
    s1, _ = step64(params64, state64, DT)
    with plain_kernels("the f64 comparison step"):
        s1_ref, _ = step64(params64, state64, DT)
    e64 = world_rel(s1.v, s1_ref.v)
    check(share(e64, 1e-8) >= 0.999 and float(e64.median()) <= 1e-10,
          f"one-step v kernel vs plain, f64: within 1e-8 on "
          f"{share(e64, 1e-8):.3%} of worlds, median {float(e64.median()):.2e}"
          f", max {float(e64.max()):.2e}")

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_slice_golden.json")) as f:
        rec = json.load(f)
    stepg, paramsg, stateg = slice_scene(torch, dev, torch.float64,
                                         np.asarray(rec["p0"]),
                                         np.asarray(rec["v0"]))
    fin, traj_g, _ = timed_rollout(torch, stepg, paramsg, stateg, 3)
    for k, got, tol in (("p1", traj_g.p[0], 1e-8), ("v1", traj_g.v[0], 1e-8),
                        ("p3", fin.p, 1e-6), ("v3", fin.v, 1e-6)):
        e = float((got.cpu() - torch.tensor(rec[k], dtype=torch.float64))
                  .abs().max())
        check(e <= tol, f"B=8 f64 kernel path vs JAX record {k}: "
                        f"{e:.2e} <= {tol:g}")
    return launches


def timed_train(torch, step, params, state, n_steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = train_step(torch, step, params, state, n_steps)
    torch.cuda.synchronize()
    return loss, grads, time.perf_counter() - t0


def ulp(p0):
    """p0 moved by about one float32 ulp (numpy, seed 1)."""
    return p0 * (1 + 2.0 ** -23
                 * np.random.default_rng(1).standard_normal(p0.shape))


def all_finite(torch, loss, grads):
    return bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


def phase_train(torch, dev, smi):
    """The dense training step at f32 (K4) and f64 (K5), and the B = 2 f64
    grid against the JAX record.  Returns the launch counts of the f32 and
    the f64 runs."""
    from lcp_physics_tpu_torch.core import rollout
    from lcp_physics_tpu_torch.lcp import pdipm
    f32, f64 = torch.float32, torch.float64
    p0, v0 = grid_start(TRAIN_B, TRAIN_SIDE)
    step, params, state = train_scene(torch, dev, f32, p0, v0, TRAIN_C)
    train_step(torch, step, params, state, 1)      # warm-up, not counted
    reset_counts()
    loss, grads, sec = timed_train(torch, step, params, state, TRAIN_STEPS)
    launches = launch_counts()
    print(f"training launches over {TRAIN_STEPS} steps, fwd+bwd: "
          f"{launches}", flush=True)
    check(launches["gj_inv_blocked"] > 0 and launches["gj_inv"] == 0,
          "the f32 dense training step launched the rank-16 panel kernel "
          "(and not the scalar one)")
    check(all_finite(torch, loss, grads),
          f"f32 loss {float(loss):.6e} and its gradients are finite")
    reads = pdipm.HOST_READS["ipm_loop"]
    with torch.no_grad():
        _, _, sec_fwd = timed_rollout(torch, step, params, state,
                                      TRAIN_STEPS)
    reads = (pdipm.HOST_READS["ipm_loop"] - reads) / TRAIN_STEPS
    # capped: one step, every world held at CAP_ITERS IPM iterations (no
    # stopping rule fires), where the f32 gradient is well conditioned
    cap = dict(max_iter=CAP_ITERS, solver_eps=0.0, solver_stall_lim=0)
    step_c, params_c, state_c = train_scene(torch, dev, f32, p0, v0, TRAIN_C,
                                            **cap)
    _, grads_c = train_step(torch, step_c, params_c, state_c, 1)
    with plain_kernels("the f32 training comparison runs"):
        loss_r, grads_r, sec_r = timed_train(torch, step, params, state,
                                             TRAIN_STEPS)
        step_u, params_u, state_u = train_scene(torch, dev, f32, ulp(p0), v0,
                                                TRAIN_C)
        _, grads_u, _ = timed_train(torch, step_u, params_u, state_u,
                                    TRAIN_STEPS)
        _, grads_cr = train_step(torch, step_c, params_c, state_c, 1)
    for s, path in ((sec, "kernel"), (sec_r, "plain")):
        print(f"dense training step, {path} path: {1e3 * s:.1f} ms per "
              f"fwd+bwd, {TRAIN_B * TRAIN_STEPS / s:,.0f} grad-world-steps/s"
              f" (B={TRAIN_B}, f32, {TRAIN_STEPS} steps; {smi})", flush=True)
    print(f"dense forward only, kernel path: {1e3 * sec_fwd / TRAIN_STEPS:.2f}"
          f" ms/step; {reads:.1f} host reads per step in the IPM loop",
          flush=True)
    e = world_rel(grads_c[3], grads_cr[3])
    check(float(e.max()) <= 1e-5 and float(e.median()) <= 1e-6,
          f"f32 v0-gradient kernel vs plain, one step capped at {CAP_ITERS} "
          f"IPM iterations: every world within {float(e.max()):.2e} "
          f"(<= 1e-5), median {float(e.median()):.2e} (<= 1e-6)")
    # Full 8-step run: the dense scene is chaotic and its f32 gradient
    # moves by ~1e-2 under one ulp of input, so kernel vs plain is held to
    # the plain path's own spread (B = 256: a share is good to ~3 points).
    e, e_ulp = (world_rel(g[3], grads_r[3]) for g in (grads, grads_u))
    check(float(e.median()) <= 2 * float(e_ulp.median())
          and share(e, 1e-2) >= share(e_ulp, 1e-2) - 0.05,
          f"f32 v0-gradient kernel vs plain, {TRAIN_STEPS} steps: median "
          f"world {float(e.median()):.2e}, within 1e-2 on {share(e, 1e-2):.2%}"
          f" of worlds, max {float(e.max()):.2e} (plain at p0+1ulp: median "
          f"{float(e_ulp.median()):.2e}, within 1e-2 on "
          f"{share(e_ulp, 1e-2):.2%}, max {float(e_ulp.max()):.2e}); loss "
          f"{float(loss):.6e} vs plain {float(loss_r):.6e}")

    p0, v0 = grid_start(TRAIN_B64, TRAIN_SIDE, seed=2)
    step, params, state = train_scene(torch, dev, f64, p0, v0, TRAIN_C)
    reset_counts()
    loss, grads, sec = timed_train(torch, step, params, state, TRAIN_STEPS)
    launches64 = launch_counts()
    check(launches64["gj_inv"] > 0 and launches64["gj_inv_blocked"] == 0,
          f"the f64 dense training step launched the scalar panel kernel "
          f"({launches64['gj_inv']} launches), not the rank-16 one")
    with plain_kernels("the f64 training comparison run"):
        loss_r, grads_r, sec_r = timed_train(torch, step, params, state,
                                             TRAIN_STEPS)
    e = world_rel(grads[3], grads_r[3])
    eg = max(rel_err(g[None], r[None]) for g, r in zip(grads[:3], grads_r[:3]))
    el = abs(float(loss) / float(loss_r) - 1)
    check(all_finite(torch, loss, grads) and float(e.max()) <= 1e-8
          and eg <= 1e-8 and el <= 1e-12,
          f"f64 kernel vs plain: v0-gradient per world max "
          f"{float(e.max()):.2e} (median {float(e.median()):.2e}); mass, "
          f"restitution, fric_coeff gradients {eg:.2e}; loss {el:.2e} "
          f"({1e3 * sec:.0f} ms vs plain {1e3 * sec_r:.0f} ms per fwd+bwd, "
          f"B={TRAIN_B64})")

    per_step(torch, f"f64 dense training step (B={TRAIN_B64}, fwd+bwd)",
             lambda: train_step(torch, step, params, state, TRAIN_STEPS),
             TRAIN_STEPS, smi)
    hold_record(torch, dev, "torch_train_golden.json")
    return launches, launches64


def hold_record(torch, dev, name):
    """The B = 2 f64 grid's loss (1e-10) and gradients (1e-8) through the
    kernels against the JAX record tests/data/<name>, under the record's
    SimConfig fields."""
    with open(os.path.join(ROOT, "tests", "data", name)) as f:
        rec = json.load(f)
    cfg = rec.get("config", {})
    step, params, state = train_scene(
        torch, dev, torch.float64, np.asarray(rec["p0"]),
        np.asarray(rec["v0"]), rec["c_max"], **cfg)
    loss, grads = train_step(torch, step, params, state, rec["steps"])
    what = f"B=2 f64 grid {cfg or ''} vs JAX record"
    el = abs(float(loss) / rec["loss"] - 1)
    check(el <= 1e-10, f"{what}: loss {el:.2e} (<= 1e-10)")
    for k, g in zip(("mass", "restitution", "fric_coeff", "v0"), grads):
        want = torch.tensor(rec["grad_" + k], dtype=torch.float64)
        e = float((g.cpu() - want).abs().max()
                  / max(1.0, float(want.abs().max())))
        check(e <= 1e-8, f"{what}: d loss/d {k} {e:.2e} (<= 1e-8)")


def first_step_lcp(torch, dev, dt, B, seed=1):
    """The LCP of the dense scene's first step (the touching 8 x 8 grid of
    ``grid_start(B, 8, seed)``, c_max = 128): the keyword arguments
    make_batched_step gives lcp_solve."""
    import lcp_physics_tpu_torch.core.step as step_mod
    step, params, state = train_scene(torch, dev, dt,
                                      *grid_start(B, TRAIN_SIDE, seed),
                                      TRAIN_C)
    seen = {}
    orig = step_mod.lcp_solve

    def capture(**kw):
        seen.update(kw)
        return orig(**kw)
    step_mod.lcp_solve = capture
    try:
        with torch.no_grad():
            step(params, state, DT)
    finally:
        step_mod.lcp_solve = orig
    return seen


def iter_operands(torch, lcp):
    """K6's operands for ``lcp`` (first_step_lcp's): Ghat and Q^-1, the
    initial iterate X0, the rotated factor (its ``iter_inv_raw`` builds the
    inverse) and the dtype's constants."""
    from lcp_physics_tpu_torch.lcp import pdipm
    from lcp_physics_tpu_torch.ops import ipm
    Q, p, G, h, A, b, F = (lcp[k] for k in "Q p G h A b F".split())
    rmask = lcp["row_mask"].to(p.dtype)
    consts = pdipm._dtype_consts(p.dtype)
    ops = ipm.rot_operands(Q, G, A, F.C)
    fac = pdipm._rot_factor_factory(ops, F, consts["reg"])
    X0 = torch.cat(pdipm._start(fac, p, h, b, rmask, consts), -1)
    vecs = (ops[1], ops[2], p, h, b, F.mu, F.valid, rmask)
    return vecs, X0, fac, consts


def engine_iter_case(torch, dev, Bn, n, C, q, dt, seed):
    """K6's operands on ``engine_instance`` LCPs (numpy, ``seed``): the
    vectors, X0, the inverse at X0's scaling, the dtype's constants."""
    from lcp_physics_tpu_torch.lcp.cone import ConeF
    from lcp_physics_tpu_torch.lcp.pdipm import (_dtype_consts,
                                                 _rot_factor_factory, _start)
    from lcp_physics_tpu_torch.ops import ipm
    qd, p, G, h, A, b, mu, valid, rmask = (
        torch.tensor(x, dtype=dt, device=dev)
        for x in engine_instance(np.random.default_rng(seed), Bn, n, C, q))
    consts = _dtype_consts(dt)
    ops = ipm.rot_operands(qd, G, A, C)
    fac = _rot_factor_factory(ops, ConeF(mu, valid), consts["reg"])
    X0 = torch.cat(_start(fac, p, h, b, rmask, consts), -1)
    m = 4 * C
    d_inv = torch.clamp(X0[:, n:n + m] / X0[:, n + m:n + 2 * m],
                        consts["dinv_min"], consts["dinv_max"])
    vecs = (ops[1], ops[2], p, h, b, mu, valid, rmask)
    return vecs, X0, fac, fac.iter_inv_raw(d_inv), consts


def iter_attrs(torch):
    """K6's registers and spills at both dtypes."""
    import ctypes
    from lcp_physics_tpu_torch.ops import ipm_iter
    lib = ipm_iter._lib()
    out = (ctypes.c_int * 2)()
    row = []
    for f64 in (0, 1):
        ipm_iter._build.check(lib, lib.lcp_ipm_iter_attrs(f64, out),
                              "lcp_ipm_iter_attrs")
        row.append(f"{'f64' if f64 else 'f32'} {out[0]} regs, {out[1]} B"
                   " local")
    print("  K6: " + "; ".join(row), flush=True)


def hold_iter(torch, tag, vecs, X0, inv, fac, consts, C, lims, cap_lim):
    """K6 against its plain iteration: one iteration from the same inputs
    (per world: X, bestX, state within ``lims``), then runs capped at
    CAP_ITERS iterations (z and lam within ``cap_lim``; at float32 within
    max(cap_lim, 10x the plain run's own spread at p + 1 ulp), as
    tests/test_torch_cuda.py holds them)."""
    from lcp_physics_tpu_torch.ops import ipm_iter
    Bn, n = vecs[2].shape
    m = 4 * C
    kw = dict(C=C, consts=consts, tol=1e-8, not_improved_lim=3,
              stall_rtol=0.0)
    a = (inv, *vecs, X0, X0, ipm_iter.initial_state(Bn, 10, X0.dtype,
                                                     X0.device), 0)
    got = ipm_iter.iteration(*a, **kw)
    ref = ipm_iter._iter_ref(*a, **kw)
    torch.cuda.synchronize()
    errs = [float(world_rel(g, r).max()) for g, r in zip(got, ref)]
    cap = dict(C=C, consts=consts, max_iter=CAP_ITERS, tol=0.0,
               not_improved_lim=0, inv_raw=fac.iter_inv_raw)
    g3 = ipm_iter.fused_iter_ipm(*vecs, X0, **cap)
    r3 = ipm_iter.fused_iter_ipm_ref(*vecs, X0, **cap)
    ez = world_rel(g3[0][:, :n], r3[0][:, :n])
    el = world_rel(g3[0][:, n + m:n + 2 * m], r3[0][:, n + m:n + 2 * m])
    e3 = float(torch.maximum(ez, el).max())
    spread = ""
    if X0.dtype == torch.float32:
        u3 = ipm_iter.fused_iter_ipm_ref(vecs[0], vecs[1],
                                         ulp_tensor(torch, vecs[2]),
                                         *vecs[3:], X0, **cap)
        eu = float(torch.maximum(
            world_rel(u3[0][:, :n], r3[0][:, :n]),
            world_rel(u3[0][:, n + m:n + 2 * m],
                      r3[0][:, n + m:n + 2 * m])).max())
        cap_lim = max(cap_lim, 10 * eu)
        spread = f"; plain at p+1ulp: {eu:.2e}"
    check(all(e <= lim for e, lim in zip(errs, lims)) and e3 <= cap_lim,
          f"K6 {tag}: one iteration per world X {errs[0]:.2e}, bestX "
          f"{errs[1]:.2e}, state {errs[2]:.2e} (<= {lims}); {CAP_ITERS} "
          f"iterations z, lam {e3:.2e} (<= {cap_lim:.3g}{spread})")


def iter_bound(inv, vecs, X, C):
    """K6's bound for one launch on which no world is done: the K2 x K2
    inverse block, Ghat, the vectors, X, bestX and the state read once, X,
    bestX and the state written once; 2 inverse matvecs (4 K2^2) and 4
    Ghat products (8 K2 n) per world."""
    Ghat = vecs[0]
    B, K2, n = Ghat.shape
    it = X.element_size()
    moved = (B * K2 * K2 * it + nbytes(*vecs) + 4 * nbytes(X)
             + 2 * B * 4 * it)
    return bound(moved, B * (4 * K2 * K2 + 8 * K2 * n), it)


def phase_ipm_iter(torch, dev):
    """K6 against its plain iteration on the dense scene's first-step LCP:
    one iteration from the same inputs (B = 256 f32, B = 32 f64), runs
    capped at CAP_ITERS iterations, and a full f32 run against plain's own
    one-ulp spread; timings of K6, the plain iteration and the inverse
    build."""
    from lcp_physics_tpu_torch.ops import ipm_iter
    iter_attrs(torch)
    # large n (the products over many column tiles), and a Schur system of
    # rank 64 in 256 rows (tests/test_torch_cuda.py::ITER_CASES' worst
    # conditioned, the plain f32 run's own one-ulp spread past 1e-3)
    for Bn, n, C_, q, dt, lims, cap_lim, seed in (
            (5, 1201, 128, 0, torch.float64, (1e-10,) * 3, 1e-8, 1201),
            (7, 2001, 128, 0, torch.float32, (1e-3, 0.0, 1e-5), 1e-3, 2001),
            (13, 64, 124, 8, torch.float32, (1e-3, 0.0, 1e-5), 1e-3, 196)):
        vecs, X0, fac, inv, consts = engine_iter_case(
            torch, dev, Bn, n, C_, q, dt, seed)
        hold_iter(torch, f"(B={Bn}, n={n}, K2={2 * C_ + q}) "
                  f"{str(dt)[6:]}", vecs, X0, inv, fac, consts, C_, lims,
                  cap_lim)
    out = {}
    for dt, Bn, seed in ((torch.float32, TRAIN_B, 1),
                         (torch.float64, ITER_B64, 2)):
        f64 = dt == torch.float64
        tag = f"B={Bn} {str(dt)[6:]}"
        lcp = first_step_lcp(torch, dev, dt, Bn, seed)
        vecs, X0, fac, consts = iter_operands(torch, lcp)
        C = lcp["F"].C
        n, m = vecs[2].shape[1], 4 * C
        q = vecs[4].shape[1]
        need = ipm_iter._lib().lcp_ipm_iter_smem_bytes(n, m, q, C, int(f64))
        check(ipm_iter.smem_bytes(n, C, q, X0.element_size()) == need,
              f"K6 {tag}: the dispatch's shared-memory count equals the "
              f"kernel's ({need} B per world)")
        d_inv = torch.clamp(X0[:, n:n + m] / torch.clamp(
            X0[:, n + m:n + 2 * m], min=consts["tiny"]), consts["dinv_min"],
            consts["dinv_max"])
        inv = fac.iter_inv_raw(d_inv)
        print(f"  K6 {tag} (n={n}, K2={2 * C + q}): one CTA a world, "
              f"{need} B of shared memory a CTA", flush=True)
        state = ipm_iter.initial_state(Bn, 12, dt, dev)
        kw = dict(C=C, consts=consts, tol=1e-5, not_improved_lim=1,
                  stall_rtol=0.0)
        a = (inv, *vecs, X0, X0, state, 0)
        got = ipm_iter.iteration(*a, **kw)
        ref = ipm_iter._iter_ref(*a, **kw)
        torch.cuda.synchronize()
        # f32: the direction is an inverse matvec over 256 terms summed in
        # another order than plain's; on this scene a world's X moves by
        # 1.3e-6 at most (random instances with more cancellation reach
        # 2e-4, hence tests/test_torch_cuda.py's 1e-3); f64: rounding only.
        lims = (1e-10, 1e-10, 1e-10) if f64 else (1e-4, 0.0, 1e-5)
        errs = [float(world_rel(g, r).max()) for g, r in zip(got, ref)]
        check(all(e <= lim for e, lim in zip(errs, lims)),
              f"K6 {tag}, one iteration from the same inputs, per world: X "
              f"{errs[0]:.2e} (<= {lims[0]:g}), bestX {errs[1]:.2e} (<= "
              f"{lims[1]:g}), state {errs[2]:.2e} (<= {lims[2]:g})")
        run = dict(C=C, consts=consts, inv_raw=fac.iter_inv_raw)
        cap = dict(run, max_iter=CAP_ITERS, tol=0.0, not_improved_lim=0)
        g3 = ipm_iter.fused_iter_ipm(*vecs, X0, **cap)
        r3 = ipm_iter.fused_iter_ipm_ref(*vecs, X0, **cap)
        ez = world_rel(g3[0][:, :n], r3[0][:, :n])
        el = world_rel(g3[0][:, n + m:n + 2 * m], r3[0][:, n + m:n + 2 * m])
        lim = 1e-8 if f64 else 1e-3
        check(float(torch.maximum(ez, el).max()) <= lim,
              f"K6 {tag}, {CAP_ITERS} iterations on every world: z "
              f"{float(ez.max()):.2e}, lam {float(el.max()):.2e} vs plain "
              f"(<= {lim:g})")
        if Bn != TRAIN_B:
            print(f"  K6 {tag}: "
                  f"{cuda_ms(torch, lambda: ipm_iter.iteration(*a, **kw)):.4f}"
                  " ms per launch, device time", flush=True)
        if f64 or Bn != TRAIN_B:
            continue
        full = dict(run, max_iter=12, tol=1e-5, not_improved_lim=1)
        g = ipm_iter.fused_iter_ipm(*vecs, X0, **full)
        r = ipm_iter.fused_iter_ipm_ref(*vecs, X0, **full)
        p_ulp = vecs[2] * (1 + 2.0 ** -23 * torch.randn(
            vecs[2].shape, generator=torch.Generator(dev).manual_seed(1),
            device=dev, dtype=dt))
        u = ipm_iter.fused_iter_ipm_ref(*vecs[:2], p_ulp, *vecs[3:], X0,
                                        **full)
        same, same_u = (g[3] == r[3]), (u[3] == r[3])
        e, e_u = (world_rel(x[1][:, :n], r[1][:, :n]) for x in (g, u))
        worse = float((g[2] - r[2]).max())
        worse_u = float((u[2] - r[2]).max())
        check(float(same.double().mean()) >= 0.9 * float(same_u.double().mean())
              and float(e.median()) <= max(1e-6, 4 * float(e_u.median()))
              and share(e, 1e-2) >= share(e_u, 1e-2) - 0.05
              and worse <= max(1e-3, 2 * worse_u),
              f"K6 {tag}, full runs: iterations equal on "
              f"{float(same.double().mean()):.2%} of worlds (plain at p+1ulp:"
              f" {float(same_u.double().mean()):.2%}); best z median "
              f"{float(e.median()):.2e}, within 1e-2 on {share(e, 1e-2):.2%} "
              f"(plain at p+1ulp: {float(e_u.median()):.2e}, "
              f"{share(e_u, 1e-2):.2%}); best merit at most {worse:.2e} above"
              f" plain's (p+1ulp: {worse_u:.2e})")
        out["ipm_iter"] = dict(
            max_abs_err=float((got[0] - ref[0]).abs().max()),
            ms=cuda_ms(torch, lambda: ipm_iter.iteration(*a, **kw)),
            plain_ms=cuda_ms(torch, lambda: ipm_iter._iter_ref(*a, **kw)),
            library_ms=None, **iter_bound(inv, vecs, X0, C))
        print(f"  K6 {tag}: inverse build (iter_inv_raw) "
              f"{cuda_ms(torch, lambda: fac.iter_inv_raw(d_inv)):.3f} ms per"
              " iteration", flush=True)
    return out


def device_events(torch, fn, steps):
    """Device events (kernels and copies) and device ms per step of fn()
    under torch.profiler; (None, None) if the profiler sees no device."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        return None, None
    return (sum(e.count for e in ev) / steps,
            sum(e.self_device_time_total for e in ev) / 1e3 / steps)


def per_step(torch, what, fn, steps, smi):
    """fn() once more for its host reads and once under the profiler; prints
    the per-step figures and returns the host reads per step."""
    from lcp_physics_tpu_torch.lcp import pdipm
    reads = pdipm.HOST_READS["ipm_loop"]
    fn()
    reads = (pdipm.HOST_READS["ipm_loop"] - reads) / steps
    events, dev_ms = device_events(torch, fn, steps)
    shown = ("not measured" if events is None else
             f"{events:.0f} device events, {dev_ms:.3f} ms of device time")
    print(f"  {what}: {reads:.1f} host reads per step; {shown} per step "
          f"({smi})", flush=True)
    return reads


def phase_fuse_iter(torch, dev, smi):
    """Path (b): the dense scene's forward (B = 256 f32, TRAIN_STEPS
    steps) with pdipm.FUSE_ITER set: K6 per IPM iteration after the
    inverse build.  Counts reset just before, K6 and K4 > 0 after; one-step
    v against the plain path, held to plain's one-ulp spread; ms/step in
    turns with the unfused loop.  Returns the launch counts."""
    from lcp_physics_tpu_torch.lcp import pdipm
    f32 = torch.float32
    p0, v0 = grid_start(TRAIN_B, TRAIN_SIDE)

    def fwd(fuse, p=p0, n=TRAIN_STEPS):
        step, params, state = train_scene(torch, dev, f32, p, v0, TRAIN_C)
        pdipm.FUSE_ITER = fuse
        try:
            with torch.no_grad():
                return timed_rollout(torch, step, params, state, n)
        finally:
            pdipm.FUSE_ITER = False
    fwd(True, n=1)
    fwd(False, n=1)                                  # warm-ups
    reset_counts()
    _, traj, _ = fwd(True)
    launches = launch_counts()
    print(f"path (b) launches over {TRAIN_STEPS} steps: {launches}",
          flush=True)
    check(launches["ipm_iter"] > 0 and launches["gj_inv_blocked"] > 0,
          "the FUSE_ITER forward launched K6 (ipm_iter) and K4")
    check(bool(torch.isfinite(traj.p).all() and torch.isfinite(traj.v).all()),
          "every state of the FUSE_ITER rollout is finite")
    _, t1, _ = fwd(True, n=1)
    with plain_kernels("the FUSE_ITER comparison steps"):
        _, t1_r, _ = fwd(True, n=1)
        _, t1_u, _ = fwd(True, p=ulp(p0), n=1)
    e, e_u = (world_rel(t.v[0], t1_r.v[0]) for t in (t1, t1_u))
    check(float(e.median()) <= max(1e-6, 4 * float(e_u.median()))
          and share(e, 1e-3) >= share(e_u, 1e-3) - 0.05,
          f"FUSE_ITER one-step v kernel vs plain, f32: median world "
          f"{float(e.median()):.2e}, within 1e-3 on {share(e, 1e-3):.2%} "
          f"(plain at p0+1ulp: {float(e_u.median()):.2e}, "
          f"{share(e_u, 1e-3):.2%})")
    _, t1_unf, _ = fwd(False, n=1)
    e_unf = world_rel(t1_unf.v[0], t1.v[0])
    print(f"  FUSE_ITER vs the unfused loop, one-step v: median world "
          f"{float(e_unf.median()):.2e}, max {float(e_unf.max()):.2e}",
          flush=True)
    times = {False: [], True: []}
    for fuse in (False, True, True, False):
        times[fuse].append(fwd(fuse)[2])
    for fuse, what in ((False, "unfused loop"), (True, "FUSE_ITER (K6)")):
        ms = ", ".join(f"{1e3 * t / TRAIN_STEPS:.2f}" for t in times[fuse])
        print(f"dense forward, {what}: {ms} ms/step (B={TRAIN_B}, f32, "
              f"{TRAIN_STEPS} steps, in turns unfused, K6, K6, unfused; "
              f"{smi})", flush=True)
        per_step(torch, f"dense forward, {what}",
                 lambda: fwd(fuse), TRAIN_STEPS, smi)
    return launches


def phase_refine(torch, dev, smi):
    """Path (a): the dense training step at SimConfig(solver_refine=1),
    B = 256 f32 (the explicit inverse through K4, two refinement steps per
    solve, forward and backward); the capped one-step v0-gradient against
    plain per world; the B = 2 f64 record at refine 1; the median final
    merit of the first step's worlds at refine 0 and 1; ms per fwd+bwd at
    refine 0 and 1 in turns.  Returns the launch counts."""
    from lcp_physics_tpu_torch.lcp import lcp_solve_full
    f32 = torch.float32
    p0, v0 = grid_start(TRAIN_B, TRAIN_SIDE)
    scenes = {r: train_scene(torch, dev, f32, p0, v0, TRAIN_C,
                             solver_refine=r) for r in (0, 1)}
    for r in (0, 1):
        train_step(torch, *scenes[r], 1)           # warm-ups, not counted
    step, params, state = scenes[1]
    reset_counts()
    loss, grads, _ = timed_train(torch, step, params, state, TRAIN_STEPS)
    launches = launch_counts()
    print(f"path (a) launches over {TRAIN_STEPS} steps, fwd+bwd: {launches}",
          flush=True)
    check(launches["gj_inv_blocked"] > 0,
          "the refine=1 training step launched K4")
    check(all_finite(torch, loss, grads),
          f"refine=1 f32 loss {float(loss):.6e} and its gradients are finite")
    times = {0: [], 1: []}
    for r in (0, 1, 1, 0):
        times[r].append(timed_train(torch, *scenes[r], TRAIN_STEPS)[2])
    for r in (0, 1):
        ms = ", ".join(f"{1e3 * t:.1f}" for t in times[r])
        print(f"dense training step at solver_refine={r}: {ms} ms per "
              f"fwd+bwd (B={TRAIN_B}, f32, {TRAIN_STEPS} steps, in turns "
              f"refine 0, 1, 1, 0; {smi})", flush=True)
    per_step(torch, "dense training step at solver_refine=1",
             lambda: train_step(torch, step, params, state, TRAIN_STEPS),
             TRAIN_STEPS, smi)
    cap = dict(max_iter=CAP_ITERS, solver_eps=0.0, solver_stall_lim=0,
               solver_refine=1)
    step_c, params_c, state_c = train_scene(torch, dev, f32, p0, v0, TRAIN_C,
                                            **cap)
    _, grads_c = train_step(torch, step_c, params_c, state_c, 1)
    with plain_kernels("the refine=1 comparison step"):
        _, grads_cr = train_step(torch, step_c, params_c, state_c, 1)
    e = world_rel(grads_c[3], grads_cr[3])
    check(float(e.max()) <= 1e-5,
          f"refine=1 f32 v0-gradient kernel vs plain, one step capped at "
          f"{CAP_ITERS} IPM iterations: every world within "
          f"{float(e.max()):.2e} (<= 1e-5), median {float(e.median()):.2e}")
    hold_record(torch, dev, "torch_refine_golden.json")
    lcp = first_step_lcp(torch, dev, f32, TRAIN_B)
    for refine in (0, 1):
        with torch.no_grad():
            sol = lcp_solve_full(**dict(lcp, refine=refine))
        merit = sol.mu + sol.resid
        print(f"  first dense step's LCP at refine={refine}: median final "
              f"merit (mu + resid) {float(merit.median()):.3e}, max "
              f"{float(merit.max()):.3e} (B={TRAIN_B}, f32; {smi})",
              flush=True)
    return launches


LCP_KW = dict(max_iter=15, tol=1e-6, gamma_rows=C, not_improved_lim=1)
LCP_B64 = 256   # path (c)'s float64 checks: the first worlds of the batch


def slice_lcp(torch, dev, dt, Bn=None):
    """The LCPs of bench.py::bench_lcp_solves: the first step of the
    forward slice's scene (the first ``Bn`` worlds of slice_start(B)),
    assembled by make_assemble: lcp_solve's keyword arguments Q, p, G, h,
    A, b, F and row_mask."""
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_assemble, make_scene_static)
    from lcp_physics_tpu_torch.utils import SimConfig
    Bn = Bn or B
    p0, v0 = (x[:Bn] for x in slice_start(B))
    static = make_scene_static([1] * N, c_max=C)
    params = default_params(static, verts=np.zeros((N, 1, 2)),
                            radius=np.full(N, 1.0), gravity=(0.0, 10.0),
                            restitution=0.4, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(Bn, dtype=dt, device=dev))
    assemble, _ = make_assemble(static,
                                SimConfig(max_iter=15, solver_eps=1e-6))
    with torch.no_grad():
        blocks, _ = assemble(params, state,
                             torch.full((Bn,), DT, dtype=dt, device=dev))
    return blocks


def lcp_fwd_bwd(torch, blocks, backward=True, **kw):
    """z of lcp_solve on ``blocks`` and, with ``backward``, the gradients of
    sum(z^2) with respect to h and F.mu."""
    from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve
    F = blocks["F"]
    h = blocks["h"].clone().requires_grad_(backward)
    mu = F.mu.clone().requires_grad_(backward)
    args = dict(blocks, h=h, F=ConeF(mu, F.valid, F.fd))
    if not backward:
        with torch.no_grad():
            return lcp_solve(**args, **kw), None, None
    z = lcp_solve(**args, **kw)
    gh, gmu = torch.autograd.grad((z ** 2).sum(), (h, mu))
    return z.detach(), gh, gmu


def phase_lcp(torch, dev, smi):
    """Path (c), the library API on the benchmark scene's LCPs (B = 4096,
    f32, LCP_KW): (i) lcp_solve with the library default fric_pair=False,
    forward through K3u and the backward of sum(z^2) through the unrotated
    factor's K1/K2, held to the plain path; (ii) the same LCPs with
    fric_pair=True, against (i) at f64; (iii) (i) and (ii) timed in turns;
    (iv) LCPFunction with a dense Q and F (the 56-row dense KKT); (v)
    solve_eq_kkt.  Returns the launch counts of (i)."""
    from lcp_physics_tpu_torch.lcp import (ConeF, LCPFunction,
                                           lcp_solve_full, solve_eq_kkt)
    f32, f64 = torch.float32, torch.float64
    blocks = slice_lcp(torch, dev, f32)
    m = blocks["G"].shape[1]
    active = float(blocks["F"].valid.sum(-1).mean())
    print(f"  path (c): B={B} n={blocks['p'].shape[1]} m={m} "
          f"q={blocks['A'].shape[1]}, {active:.2f} active contacts per "
          "world", flush=True)
    run = lambda fp, bw=True, **kw: lcp_fwd_bwd(
        torch, blocks, bw, fric_pair=fp, **dict(LCP_KW, **kw))
    run(False)
    run(True)                                       # warm-ups, not counted
    reset_counts()
    z, gh, gmu = run(False)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"path (c) (i) launches, fwd+bwd: {launches}", flush=True)
    check(launches["fused_ipm_unrot"] > 0 and launches["fused_ipm"] == 0
          and all(launches[k] > 0 for k in ("lu", "solve", "solve_t")),
          "path (c) (i): lcp_solve(fric_pair=False) launched K3u "
          "(fused_ipm_unrot, not the rotated K3) forward and K1/K2's "
          "trans=1 solve backward")
    check(all(bool(torch.isfinite(x).all()) for x in (z, gh, gmu)),
          "path (c) (i): z and its gradients are finite")

    # capped: every world held at CAP_ITERS iterations, per world
    cap = dict(max_iter=CAP_ITERS, tol=0.0, not_improved_lim=0)
    zc, ghc, gmc = run(False, **cap)
    got = lcp_solve_full(**blocks, fric_pair=False, **LCP_KW)
    with plain_kernels("path (c)'s comparison runs"):
        zc_r, ghc_r, gmc_r = run(False, **cap)
        ref = lcp_solve_full(**blocks, fric_pair=False, **LCP_KW)
        pert = lcp_solve_full(**dict(blocks, p=ulp_tensor(torch, blocks["p"])),
                              fric_pair=False, **LCP_KW)
    errs = [world_rel(a, r) for a, r in ((zc, zc_r), (ghc, ghc_r),
                                         (gmc, gmc_r))]
    check(all(float(e.max()) <= 1e-3 and float(e.median()) <= 1e-5
              for e in errs),
          f"path (c) (i), {CAP_ITERS} iterations on every world, kernel vs "
          "plain: z, d/dh, d/dmu per world max "
          + ", ".join(f"{float(e.max()):.2e}" for e in errs) + " (<= 1e-3),"
          " median " + ", ".join(f"{float(e.median()):.2e}" for e in errs)
          + " (<= 1e-5)")
    hold_full_f32(torch, "path (c) (i) lcp_solve_full(fric_pair=False)",
                  got, ref, pert)

    # (ii) the rotated solve of the same LCPs, f64: the same solution
    b64 = slice_lcp(torch, dev, f64, LCP_B64)
    kw64 = dict(max_iter=25, tol=1e-11, gamma_rows=C, not_improved_lim=3)
    s_u = lcp_solve_full(**b64, fric_pair=False, **kw64)
    s_r = lcp_solve_full(**b64, fric_pair=True, **kw64)
    ez = float((s_u.z - s_r.z).abs().max())
    # lam is unique only where the contact rows are independent; elsewhere
    # the two splits of one impulse G^T lam are both right
    el = (s_u.lam - s_r.lam).abs().amax(-1)
    ei = torch.einsum("bmn,bm->bn", b64["G"], s_u.lam - s_r.lam).abs() \
        .amax(-1)
    check(ez <= 1e-6 and share(el, 1e-4) >= 0.95
          and bool(((el <= 1e-4) | (ei <= 1e-6)).all()),
          f"path (c) (ii), f64, {LCP_B64} worlds: fric_pair=False vs True "
          f"z {ez:.2e} (<= 1e-6); lam within 1e-4 on {share(el, 1e-4):.2%}"
          f" of worlds (>= 95%), on the others the impulse G^T lam within "
          f"{float(torch.where(el > 1e-4, ei, 0.0).max()):.2e} (<= 1e-6); "
          f"merit max {float((s_u.mu + s_u.resid).max()):.2e}, "
          f"{float((s_r.mu + s_r.resid).max()):.2e}")

    # (iii) fric_pair False and True in turns, forward and fwd+bwd
    times = {}
    for fp in (False, True, True, False):
        for bw in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(fp, bw)
            torch.cuda.synchronize()
            times.setdefault((fp, bw), []).append(
                1e3 * (time.perf_counter() - t0))
    for (fp, bw), ts in sorted(times.items()):
        print(f"path (c) (iii) lcp_solve(fric_pair={fp}) "
              f"{'fwd+bwd' if bw else 'forward'}: "
              + ", ".join(f"{x:.3f}" for x in ts)
              + f" ms per batch (B={B}, f32, in turns False, True, True, "
              f"False; {smi})", flush=True)
    for fp in (False, True):
        events, dev_ms = device_events(torch, lambda: run(fp, False), 1)
        shown = ("not measured" if events is None else
                 f"{events:.0f} device events, {dev_ms:.3f} ms of device "
                 "time")
        print(f"  path (c) (iii) lcp_solve(fric_pair={fp}) forward: {shown}"
              f" per batch ({smi})", flush=True)

    # (iv) LCPFunction: dense Q and F, no gamma elimination and no row
    # mask (the dense KKT), against (i) at f64, both to the f64 floor
    reset_counts()
    z_f = LCPFunction(eps=kw64["tol"], maxIter=kw64["max_iter"])(
        torch.diag_embed(b64["Q"]), b64["p"], b64["G"], b64["h"], b64["A"],
        b64["b"], b64["F"].dense())
    dense = launch_counts()
    e = float((z_f - s_u.z).abs().max())
    check(dense["lu"] > 0 and dense["solve"] > 0 and e <= 1e-6,
          f"path (c) (iv) LCPFunction, dense Q and F ({b64['p'].shape[1]} + "
          f"{m} rows: K1 {dense['lu']}, K2 {dense['solve']} launches), f64 "
          f"{LCP_B64} worlds: z vs (i) {e:.2e} (<= 1e-6)")

    # (v) the equality-only KKT on one batch of random systems
    rng = np.random.default_rng(5)
    n, q = blocks["p"].shape[1], 3
    t32 = lambda x: torch.tensor(x, dtype=f32, device=dev)
    Q = torch.diag_embed(t32(rng.uniform(0.5, 2.0, (B, n))))
    p, A, b = (t32(rng.standard_normal(s)) for s in ((B, n), (B, q, n),
                                                      (B, q)))
    reset_counts()
    zq, nu = solve_eq_kkt(Q, p, A, b)
    eqn = launch_counts()
    r1 = (torch.einsum("bij,bj->bi", Q, zq) + p
          + torch.einsum("bqn,bq->bn", A, nu)).abs().max()
    r2 = (torch.einsum("bqn,bn->bq", A, zq) - b).abs().max()
    check(eqn["lu"] > 0 and max(float(r1), float(r2)) <= 1e-4,
          f"path (c) (v) solve_eq_kkt, B={B}, n={n}, q={q}, f32: residuals "
          f"{float(r1):.2e}, {float(r2):.2e} (<= 1e-4)")
    return launches


def phase_stats(torch, dev, smi):
    """utils.observe.solver_stats at full width: the forward slice's scene
    (B = 4096 f32, through K3u) and the dense 64-circle scene (B = 256
    f32, c_max = 128: the unrotated K = 384 over three panels, through
    K4), each against its plain version."""
    from lcp_physics_tpu_torch.core import make_scene_static
    from lcp_physics_tpu_torch.utils import SimConfig
    from lcp_physics_tpu_torch.utils.observe import solver_stats
    p0, v0 = slice_start(B)
    gp0, gv0 = grid_start(TRAIN_B, TRAIN_SIDE)
    scenes = [
        ("slice", "fused_ipm_unrot", make_scene_static([1] * N, c_max=C),
         SimConfig(max_iter=15, solver_eps=1e-6),
         lambda p: slice_scene(torch, dev, torch.float32, p, v0)[1:], p0),
        ("dense", "gj_inv_blocked",
         make_scene_static([1] * TRAIN_SIDE ** 2, c_max=TRAIN_C),
         SimConfig(max_iter=12, solver_eps=1e-5),
         lambda p: train_scene(torch, dev, torch.float32, p, gv0,
                               TRAIN_C)[1:], gp0)]
    for what, kernel, static, cfg, scene, p_np in scenes:
        params, state = scene(p_np)
        solver_stats(static, cfg, params, state, DT)      # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solver_stats(static, cfg, params, state, DT)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = launch_counts()
        with plain_kernels(f"solver_stats {what}'s comparison runs"):
            ref = solver_stats(static, cfg, params, state, DT)
            pert = solver_stats(static, cfg, *scene(ulp(p_np)), DT)
        frac = float((sol.iters == ref.iters).double().mean())
        frac_ulp = float((pert.iters == ref.iters).double().mean())
        merit, merit_r = (float((x.mu + x.resid).median()) for x in (sol, ref))
        check(launches[kernel] > 0 and (frac >= 0.9 or frac >= frac_ulp - 0.05)
              and merit <= 2 * merit_r and bool(torch.isfinite(sol.z).all()),
              f"solver_stats, {what} scene (B={sol.z.shape[0]}, f32): "
              f"{kernel} launched {launches[kernel]} times; iterations equal "
              f"to plain on {frac:.2%} of worlds (>= 90%, or plain at "
              f"p0+1ulp's {frac_ulp:.2%} less 5 points); median merit "
              f"{merit:.3e} vs plain {merit_r:.3e} (<= 2x); {1e3 * sec:.1f} ms"
              f"; mean iterations {float(sol.iters.double().mean()):.2f}")


def hold_lcp_record(torch, dev):
    """The f64 JAX record tests/data/torch_lcp_golden.json of
    lcp_solve(fric_pair=False) through the kernels: its engine LCPs
    through K3u, its dense QP through K1/K2, z, lam and the gradients of
    sum(z^2) within 1e-8, the same iterations."""
    from lcp_physics_tpu_torch.lcp import ConeF, lcp_solve, lcp_solve_full
    with open(os.path.join(ROOT, "tests", "data",
                           "torch_lcp_golden.json")) as f:
        rec = json.load(f)
    reset_counts()
    for part in ("engine", "qp"):
        r = rec[part]
        g = lambda k: torch.tensor(r[k], dtype=torch.float64, device=dev)
        leaves = [g("p").requires_grad_(True), g("h").requires_grad_(True)]
        kw = dict(rec["kw"])
        if part == "engine":
            leaves.append(g("mu").requires_grad_(True))
            args = (g("qd"), leaves[0], g("G"), leaves[1], None, None,
                    ConeF(leaves[2], g("valid"), 2))
            kw.update(q_is_diag=True, gamma_rows=8, row_mask=g("rmask"))
        else:
            args = (g("Q"), leaves[0], g("G"), leaves[1], g("A"), g("b"),
                    g("F"))
        sol = lcp_solve_full(*args, **kw)
        z = lcp_solve(*args, **kw)
        grads = torch.autograd.grad((z ** 2).sum(), leaves)
        got = dict(z=sol.z, lam=sol.lam,
                   **dict(zip(("grad_p", "grad_h", "grad_mu"), grads)))
        errs = {k: float((x.cpu() - torch.tensor(r[k], dtype=torch.float64))
                         .abs().max()) for k, x in got.items()}
        same = sol.iters.cpu().tolist() == r["iters"]
        check(same and max(errs.values()) <= 1e-8,
              f"f64 JAX record of lcp_solve(fric_pair=False), {part}: "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + f" (<= 1e-8); iterations {'equal' if same else 'differ'}")
    launches = launch_counts()
    check(all(launches[k] > 0 for k in ("fused_ipm_unrot", "lu", "solve",
                                        "solve_t")),
          f"the record's solves launched K3u and K1/K2: {launches}")


def phase_line(torch, dev, smi):
    """The backward of the touching 8-circle line (fused forward, lane LU
    with the trans=1 substitution backward).  Returns its launch counts."""
    p0, v0 = line_start(LINE_B)
    scene = lambda p: train_scene(torch, dev, torch.float32, p, v0, 16,
                                  restitution=0.5)
    step, params, state = scene(p0)
    train_step(torch, step, params, state, 1)      # warm-up, not counted
    reset_counts()
    loss, grads, sec = timed_train(torch, step, params, state, LINE_STEPS)
    launches = launch_counts()
    print(f"line launches over {LINE_STEPS} steps, fwd+bwd: {launches}",
          flush=True)
    check(all(launches[k] > 0 for k in ("lu", "solve", "solve_t",
                                        "fused_ipm")),
          "the line's fwd+bwd launched the lu, solve (trans 0 and 1) and "
          "fused_ipm kernels")
    check(all_finite(torch, loss, grads), "line loss and gradients finite")
    with plain_kernels("the line's comparison runs"):
        loss_r, grads_r, sec_r = timed_train(torch, step, params, state,
                                             LINE_STEPS)
        step_u, params_u, state_u = scene(ulp(p0))
        _, grads_u, _ = timed_train(torch, step_u, params_u, state_u,
                                    LINE_STEPS)
    for s, path in ((sec, "kernel"), (sec_r, "plain")):
        print(f"line fwd+bwd, {path} path: {1e3 * s:.1f} ms (B={LINE_B}, "
              f"f32, {LINE_STEPS} steps; {smi})", flush=True)
    em, em_ulp = (rel_err(g[0][None], grads_r[0][None]) for g in (grads,
                                                                 grads_u))
    ev, ev_ulp = (float(world_rel(g[3], grads_r[3]).median())
                  for g in (grads, grads_u))
    check(em <= max(1e-3, 10 * em_ulp) and ev <= max(1e-3, 10 * ev_ulp),
          f"line gradients kernel vs plain: mass {em:.2e}, v0 median world "
          f"{ev:.2e} (plain at p0+1ulp: {em_ulp:.2e}, {ev_ulp:.2e}; bound "
          "the larger of 1e-3 and 10x that)")
    return launches


# ---------------------------------------------------------------------------
# The hull contact step and the object layer.
# ---------------------------------------------------------------------------

def host_reads():
    """Host reads so far: the IPM loop's, the step's branches' and
    World.step's."""
    from lcp_physics_tpu_torch.core import step as core_step
    from lcp_physics_tpu_torch.lcp import pdipm
    from lcp_physics_tpu_torch.physics import world
    return (pdipm.HOST_READS["ipm_loop"] + sum(core_step.HOST_READS.values())
            + world.HOST_READS["world_step"])


def hull_grid_start(B):
    """bench.py::build_world_scene(dense=True, hulls=True), in numpy from
    its seed and in its order: 64 squares of side 2 in a touching 8 x 8
    grid at spacing 2.01, positions jittered by uniform(-0.01, 0.01),
    velocities normal(0, 0.5) (numpy seed 1), float32, one world tiled B
    times.  Returns (p0, v0) (B, 64, 3)."""
    rng = np.random.default_rng(1)
    gx, gy = np.meshgrid(np.arange(8), np.arange(8))
    pos = np.stack([gx.ravel() * 2.01, gy.ravel() * 2.01], -1)
    pos = pos + rng.uniform(-0.01, 0.01, pos.shape)
    v0 = rng.normal(0, 0.5, (64, 3)).astype(np.float32)
    p = np.concatenate([np.zeros((64, 1)), pos], -1).astype(np.float32)
    tile = lambda x: np.broadcast_to(x, (B,) + x.shape).copy()
    return tile(p), tile(v0)


def hull_scene(torch, dev, dt, p0, v0, **cfg):
    """(step, params, state) of the hull grid: c_max = 128, gravity (0, 10),
    restitution 0.4, SimConfig(max_iter=12, solver_eps=1e-5) plus ``cfg``
    (bench.py::bench_world_steps)."""
    from lcp_physics_tpu_torch.core import (WorldState, default_params,
                                            make_scene_static)
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    static = make_scene_static([4] * 64, c_max=HULL_C)
    sq = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])
    params = default_params(static,
                            verts=np.broadcast_to(sq, (64, 4, 2)).copy(),
                            radius=np.zeros(64), gravity=(0.0, 10.0),
                            restitution=0.4, dtype=dt, device=dev)
    state = WorldState(torch.tensor(p0, dtype=dt, device=dev),
                       torch.tensor(v0, dtype=dt, device=dev),
                       torch.zeros(p0.shape[0], dtype=dt, device=dev))
    step = make_batched_step(static, SimConfig(
        **dict(dict(max_iter=12, solver_eps=1e-5), **cfg)))
    return step, params, state


def first_contacts(torch, step_cfg, params, state):
    """The contacts the step's assembly finds at ``state`` under
    ``step_cfg`` (its speculative margin and hull pair budget)."""
    from lcp_physics_tpu_torch.core import make_scene_static
    from lcp_physics_tpu_torch.core.step import make_assemble
    from lcp_physics_tpu_torch.utils import SimConfig
    static = make_scene_static([4] * 64, c_max=HULL_C)
    assemble, _ = make_assemble(static, SimConfig(**step_cfg))
    dt_w = torch.full((state.p.shape[0],), DT, dtype=state.p.dtype,
                      device=state.p.device)
    with torch.no_grad():
        c = assemble.contacts(params, state, dt_w)[0]
    return type(c)(*(x.cpu() for x in c))


def contact_set(c, w):
    """World w's valid contacts as a sorted list of exact tuples."""
    v = c.valid[w]
    cols = [c.ia[w][v], c.ib[w][v], c.depth[w][v], c.normal[w][v][:, 0],
            c.normal[w][v][:, 1], c.ra[w][v][:, 0], c.ra[w][v][:, 1]]
    return sorted(zip(*(x.tolist() for x in cols)))


def rollout_per_step(torch, what, step, params, state, steps, smi):
    """A forward rollout with the counts reset just before: its launches,
    host reads per step and host ms per step; then its device events and
    device ms per step under the profiler.  Returns (launches, final,
    trajectory, diagnostics)."""
    from lcp_physics_tpu_torch.core import rollout
    with torch.no_grad():
        step(params, state, DT)                    # warm-up, not counted
        reads = host_reads()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, traj, rd = rollout(step, params, state, DT, steps,
                                  with_diagnostics=True)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = launch_counts()
        reads = (host_reads() - reads) / steps
        events, dev_ms = device_events(
            torch, lambda: rollout(step, params, state, DT, steps), steps)
    shown = ("not measured" if events is None else
             f"{events:.0f} device events, {dev_ms:.3f} ms of device time")
    moved = {k: n for k, n in launches.items() if n}
    print(f"  {what}: {1e3 * sec / steps:.2f} ms/step on the host clock, "
          f"{reads:.1f} host reads per step; {shown} per step; launches "
          f"over {steps} steps {moved} ({smi})", flush=True)
    check(bool(torch.isfinite(traj.p).all() and torch.isfinite(traj.v).all()),
          f"{what}: every state of the rollout is finite")
    return launches, final, traj, rd


def phase_hull(torch, dev, smi):
    """(h) The hull grid (bench.py's dense hull scene, B = 256 f32, 16
    steps) at hull_pair_budget 0 and 256: K4 launched (the rotated K2 = 256
    factor), the budget's contacts those of the full pair list on the
    first step, and the first step through the kernels against the plain
    versions, held to plain's one-ulp spread.  Returns the launch counts
    of the budget-0 run."""
    from lcp_physics_tpu_torch.core import geometry
    from lcp_physics_tpu_torch.core.step import motion_margins
    f32 = torch.float32
    p0, v0 = hull_grid_start(HULL_B)
    runs = {}
    for budget in (0, 256):
        step, params, state = hull_scene(torch, dev, f32, p0, v0,
                                         hull_pair_budget=budget)
        launches, _, traj, rd = rollout_per_step(
            torch, f"hull grid, hull_pair_budget={budget} (B={HULL_B}, f32,"
            f" {HULL_STEPS} steps)", step, params, state, HULL_STEPS, smi)
        check(launches["gj_inv_blocked"] > 0,
              f"the hull grid (budget {budget}) launched K4 "
              f"({launches['gj_inv_blocked']} launches)")
        check(int(rd.total_contacts.min()) > 0,
              f"every world of the hull grid (budget {budget}) had contacts "
              f"({int(rd.total_contacts.min())} or more over the run)")
        runs[budget] = (launches, traj, step, params, state)
    # the budget is exact when it covers every pair whose AABBs, inflated
    # by the step's speculative margin, overlap
    margin = motion_margins(params, state, torch.full(
        (HULL_B,), DT, dtype=f32, device=dev), [4] * 64)
    boxes = geometry.aabbs(state.p, params.verts, params.radius, [4] * 64) \
        + torch.stack([-margin, margin], dim=-1)[..., None]
    hi, hj = geometry.split_pairs_by_kind(np.full(64, 4))["hh"]
    n_over = int((geometry.aabb_overlap_depth(
        boxes, torch.as_tensor(hi, device=dev),
        torch.as_tensor(hj, device=dev)) > 0).sum(-1).max())
    cfg = dict(max_iter=12, solver_eps=1e-5)
    c0 = first_contacts(torch, cfg, params, state)
    c256 = first_contacts(torch, dict(cfg, hull_pair_budget=256), params,
                          state)
    same = all(contact_set(c0, w) == contact_set(c256, w)
               for w in range(HULL_B))
    check(n_over <= 256 and same,
          f"first step: at most {n_over} of {len(hi)} hull pairs overlap "
          f"(<= 256), and budget 256 finds the contacts of budget 0 in every "
          f"world ({int(c0.valid[0].sum())} valid rows a world)")
    dv = float((runs[0][1].v[0] - runs[256][1].v[0]).abs().max())
    print(f"  first-step v, budget 256 vs 0: max difference {dv:.3e}",
          flush=True)
    # the first step, kernels against the plain versions
    _, _, step, params, state = runs[0]
    with torch.no_grad():
        s1, _ = step(params, state, DT)
        with plain_kernels("the hull grid's comparison steps"):
            s1_r, _ = step(params, state, DT)
            step_u, params_u, state_u = hull_scene(torch, dev, f32, ulp(p0),
                                                   v0)
            s1_u, _ = step_u(params_u, state_u, DT)
    e, e_u = (world_rel(s.v, s1_r.v) for s in (s1, s1_u))
    check(float(e.median()) <= max(1e-5, 4 * float(e_u.median()))
          and share(e, 1e-3) >= share(e_u, 1e-3) - 0.05,
          f"hull grid one-step v kernel vs plain, f32: median world "
          f"{float(e.median()):.2e}, within 1e-3 on {share(e, 1e-3):.2%} "
          f"(plain at p0+1ulp: median {float(e_u.median()):.2e}, within "
          f"1e-3 on {share(e_u, 1e-3):.2%})")
    return runs[0][0]


def phase_stab(torch, dev, smi):
    """(p) The hull grid at B = 64 with post_stabilization, then with the
    penetration backtrack: launches, host reads and device time per step,
    the halvings; then the f64 hull scene against the JAX record
    tests/data/torch_hull_golden.json (post-stabilization and the
    backtrack together)."""
    from lcp_physics_tpu_torch.core import (JointSpec, default_params,
                                            make_scene_static, rollout,
                                            WorldState)
    from lcp_physics_tpu_torch.core import step as core_step
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.utils import SimConfig
    f32 = torch.float32
    p0, v0 = hull_grid_start(STAB_B)
    for cfg in ({}, dict(post_stabilization=True),
                dict(penetration_backtrack=True)):
        step, params, state = hull_scene(torch, dev, f32, p0, v0, **cfg)
        tries = core_step.HOST_READS["backtrack"]
        launches, _, traj, rd = rollout_per_step(
            torch, f"hull grid, {cfg or 'plain step'} (B={STAB_B}, f32, "
            f"{STAB_STEPS} steps)", step, params, state, STAB_STEPS, smi)
        check(launches["gj_inv_blocked"] > 0,
              f"the hull grid with {cfg or 'the plain step'} launched K4")
        h = rd.max_halvings
        # rollout_per_step runs 1 + 2 * STAB_STEPS steps
        tries = (core_step.HOST_READS["backtrack"] - tries) \
            / (1 + 2 * STAB_STEPS)
        print(f"  halvings (most per world over the run): max {int(h.max())}"
              f", worlds that halved {int((h > 0).sum())} of {STAB_B}; "
              f"{tries:.2f} backtrack tries (host reads) per step",
              flush=True)

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_hull_golden.json")) as f:
        rec = json.load(f)
    f64 = torch.float64
    static = make_scene_static(rec["counts"], joints=[
        JointSpec(**{k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in j.items()}) for j in rec["joints"]],
        c_max=rec["c_max"])
    params = default_params(static, verts=np.asarray(rec["verts"]),
                            radius=np.asarray(rec["radius"]),
                            gravity=(0.0, 10.0), restitution=0.3,
                            fric_coeff=0.6, dtype=f64, device=dev)
    B = len(rec["p0"])
    state = WorldState(torch.tensor(rec["p0"], dtype=f64, device=dev),
                       torch.tensor(rec["v0"], dtype=f64, device=dev),
                       torch.zeros(B, dtype=f64, device=dev))
    step = make_batched_step(static, SimConfig(**rec["config"]))
    reset_counts()
    _, traj, rd = rollout(step, params, state, rec["dt"], len(rec["p"]),
                          with_diagnostics=True)
    launches = launch_counts()
    check(launches["lu"] > 0 and launches["solve"] > 0,
          f"the f64 hull record's run launched K1/K2: "
          f"{ {k: n for k, n in launches.items() if n} }")
    for k, got in (("p", traj.p), ("v", traj.v)):
        e = float((got.cpu() - torch.tensor(rec[k], dtype=f64)).abs().max())
        check(e <= 1e-8, f"f64 hull scene (post-stabilization and the "
                         f"backtrack, B={B}) vs JAX record {k}: {e:.2e} "
                         f"<= 1e-8")
    check(rd.max_halvings.tolist() == rec["max_halvings"],
          f"f64 hull scene halvings {rd.max_halvings.tolist()} equal the "
          f"JAX record's")


def phase_world(torch, dev, smi):
    """(w) The object layer on the card: hello_world and chain for
    WORLD_STEPS World.step calls each (ms per World.step, which kernel
    counters moved, host reads), a few gradient steps of the inference
    demo (its loss falls), and the host broadphase's C++ path."""
    from lcp_physics_tpu_torch import native
    from lcp_physics_tpu_torch.demos import chain, hello_world, inference
    for name, make in (("hello_world", hello_world.make_world),
                       ("chain", chain.make_world)):
        w = make()
        check(w.world_state.p.device.type == "cuda",
              f"{name}: the demo's World is on the card")
        w.step()                                   # warm-up, not counted
        reads = host_reads()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WORLD_STEPS):
            w.step()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: n for k, n in launch_counts().items() if n}
        reads = (host_reads() - reads) / WORLD_STEPS
        check(bool(torch.isfinite(w.world_state.p).all()),
              f"{name}: {WORLD_STEPS} World.step calls, finite; kernels "
              f"launched {launches}")
        if name == "hello_world":
            # the box's and a circle's AABBs overlap from the start, so
            # every step solves its K2 = 81 rotated system (lane LU)
            check(launches.get("lu", 0) > 0 and launches.get("solve", 0) > 0,
                  "hello_world's steps launched K1 and K2")
        events, dev_ms = device_events(torch, w.step, 1)
        shown = ("not measured" if events is None else
                 f"{events:.0f} device events, {dev_ms:.3f} ms of device "
                 "time")
        print(f"  {name}: {1e3 * sec / WORLD_STEPS:.2f} ms per World.step "
              f"(f32), {reads:.1f} host reads per World.step; {shown} for "
              f"one more World.step ({smi})", flush=True)
        if name == "chain":
            gaps = chain.joint_gaps(w)
            check(max(gaps) < 2.0, f"chain: joint gaps {max(gaps):.3e} < 2")
    pairs = w.broadphase_pairs()
    check(native.LAST_PATH == "cpp",
          f"World.broadphase_pairs ran native.sap_pairs' C++ path "
          f"({len(pairs)} pairs; build error: {native.BUILD_ERROR})")

    from lcp_physics_tpu_torch.core import make_step
    from lcp_physics_tpu_torch.utils import SimConfig
    static, true_params, state0 = inference.build_scene(device=dev)
    step = make_step(static, SimConfig())
    with torch.no_grad():
        target = inference.trajectory(step, true_params, state0)
    mass = torch.tensor(1.0, device=dev, requires_grad=True)
    rest = torch.tensor(0.3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([mass, rest], lr=0.05)
    reset_counts()
    losses = []
    t0 = time.perf_counter()
    for _ in range(INFER_EPOCHS):
        params = inference.with_guess(true_params, mass, rest)
        loss = ((inference.trajectory(step, params, state0) - target)
                ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    sec = time.perf_counter() - t0
    moved = {k: n for k, n in launch_counts().items() if n}
    check(losses[-1] < losses[0] and moved,
          f"inference demo: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{INFER_EPOCHS} Adam steps ({1e3 * sec / INFER_EPOCHS:.0f} ms per "
          f"{inference.STEPS}-step fwd+bwd on the card, f32; kernels "
          f"{moved}; {smi})")


# ---------------------------------------------------------------------------
# (s) Worlds sharded over a mesh, the sharded demo and the entry analogs.
# ---------------------------------------------------------------------------

def sharded_rollout(static, cfg, params, state, steps, mesh, dev):
    """``parallel.batched_rollout`` over ``mesh``, gathered on ``dev``:
    (final, trajectory)."""
    from lcp_physics_tpu_torch.parallel import batched_rollout, gather
    outs = batched_rollout(static, cfg, params, state, DT, steps, mesh=mesh)
    return (gather([o[0] for o in outs], dev),
            gather([o[1] for o in outs], dev, dim=1))


def host_ms_in_turns(torch, runs, steps, turns=2):
    """Host ms per step of each named no-argument run, timed in turns
    (a b c c b a ...): {name: [ms, ...]}."""
    out = {name: [] for name in runs}
    order = list(runs)
    for t in range(turns):
        for name in (order if t % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t0) / steps)
    return out


def phase_shard(torch, dev, smi):
    """(s) Worlds sharded over ``parallel.make_mesh()`` (this machine's
    cards) and over the card listed twice, [cuda:0, cuda:0]: (s1) the
    forward slice, held bit for bit to the unsharded step at batch_tile =
    B / shards, timed in turns with the unsharded step; (s2) the dense
    training step, its loss bit for bit and its shared-parameter
    gradients to the tiled step's; (s3) the sharded inference demo at its
    defaults (mass within 0.3), then three epochs on each mesh; (s4)
    ``entry()`` and ``dryrun_multichip``.  Returns the launch counts of
    the (s1) and (s2) runs on [cuda:0, cuda:0]."""
    import dataclasses
    from lcp_physics_tpu_torch.core import make_scene_static, rollout
    from lcp_physics_tpu_torch.demos import sharded_inference as si
    from lcp_physics_tpu_torch.entry import dryrun_multichip, entry
    from lcp_physics_tpu_torch.parallel import (make_batched_step,
                                                make_mesh, shard_worlds)
    from lcp_physics_tpu_torch.utils import SimConfig
    f32 = torch.float32
    one, two = make_mesh(), make_mesh([dev, dev])
    print(f"  meshes: make_mesh() {[str(d) for d in one.devices]}, and "
          f"{[str(d) for d in two.devices]}", flush=True)

    # (s1) the forward slice
    p0, v0 = slice_start(B)
    static = make_scene_static([1] * N, c_max=C)
    cfg = SimConfig(max_iter=15, solver_eps=1e-6)        # slice_scene's
    _, params, state = slice_scene(torch, dev, f32, p0, v0)
    runs = {"unsharded": lambda: rollout(make_batched_step(static, cfg),
                                         params, state, DT, STEPS)}
    launches = {}
    with torch.no_grad():
        for mesh in (one, two):
            k = mesh.size
            run = (lambda m: lambda: sharded_rollout(
                static, cfg, params, state, STEPS, m, dev))(mesh)
            run()                                  # warm-up, not counted
            reads = host_reads()
            reset_counts()
            _, traj = run()
            torch.cuda.synchronize()
            launches[k] = launch_counts()
            reads = (host_reads() - reads) / STEPS
            tiled = make_batched_step(static, dataclasses.replace(
                cfg, batch_tile=B // k))
            _, ref = rollout(tiled, params, state, DT, STEPS)
            diff = max(float((traj.p - ref.p).abs().max()),
                       float((traj.v - ref.v).abs().max()))
            moved = {n: c for n, c in launches[k].items() if c}
            check(diff == 0.0,
                  f"(s1) forward slice over {k} shard(s) (B={B}, f32, "
                  f"{STEPS} steps) equals the unsharded step at batch_tile ="
                  f" {B // k} bit for bit (largest difference {diff:.3e}); "
                  f"{reads:.1f} host reads per step")
            check(all(moved.get(n, 0) > 0 for n in ("lu", "solve",
                                                    "fused_ipm")),
                  f"(s1) {k} shard(s) launched K1, K2 and K3: {moved}")
            runs[f"{k} shard(s)"] = run
        # the same two shards stepped one after the other by this thread:
        # what the worker threads cost beyond the split itself
        runs["2 shards, one thread"] = lambda: [
            rollout(make_batched_step(static, cfg), params, s, DT, STEPS)
            for s in shard_worlds(state, two)]
        host = host_ms_in_turns(torch, runs, STEPS)
        for name, run in runs.items():
            events, dev_ms = device_events(torch, run, STEPS)
            shown = ("not measured" if events is None else
                     f"{events:.0f} device events, {dev_ms:.3f} ms of "
                     "device time")
            print(f"  (s1) {name}: host ms/step in turns "
                  f"{', '.join(f'{x:.2f}' for x in host[name])}; {shown} "
                  f"per step ({smi})", flush=True)

    # (s2) the dense training step over [cuda:0, cuda:0]
    p0, v0 = grid_start(TRAIN_B, TRAIN_SIDE)
    static = make_scene_static([1] * TRAIN_SIDE ** 2, c_max=TRAIN_C)
    cfg = SimConfig(max_iter=12, solver_eps=1e-5)        # train_scene's
    _, params, state = train_scene(torch, dev, f32, p0, v0, TRAIN_C)
    leaves = (params.mass, params.restitution, params.fric_coeff)

    def grads(final):
        loss = (final.p ** 2).mean()
        return loss.detach(), torch.autograd.grad(loss, leaves)

    tiled = make_batched_step(static, dataclasses.replace(
        cfg, batch_tile=TRAIN_B // 2))
    train = {
        "tiled": lambda: grads(rollout(tiled, params, state, DT,
                                       TRAIN_STEPS)[0]),
        "2 shards": lambda: grads(sharded_rollout(
            static, cfg, params, state, TRAIN_STEPS, two, dev)[0])}
    train["2 shards"]()                            # warm-up, not counted
    reset_counts()
    loss, g = train["2 shards"]()
    torch.cuda.synchronize()
    launches["train"] = launch_counts()
    loss_r, g_r = train["tiled"]()
    _, g_r2 = train["tiled"]()
    rel = lambda a, r: float((a - r).abs().max() / r.abs().max())
    e = max(rel(a, r) for a, r in zip(g, g_r))
    e_self = max(rel(a, r) for a, r in zip(g_r2, g_r))
    check(launches["train"]["gj_inv_blocked"] > 0,
          f"(s2) the sharded dense training step launched K4 "
          f"({launches['train']['gj_inv_blocked']} launches over "
          f"{TRAIN_STEPS} steps fwd+bwd)")
    # f32: each shared-parameter gradient sums 256 worlds' contributions
    # over 8 steps in the autograd engine's order, which the shards'
    # threads change; 1e-4 of its largest entry, or 4x the spread of the
    # tiled step against itself if that is larger
    check(float(loss) == float(loss_r) and e <= max(1e-4, 4 * e_self),
          f"(s2) dense training step over [cuda:0, cuda:0] (B={TRAIN_B}, "
          f"f32, {TRAIN_STEPS} steps): loss {float(loss):.6e} equals the "
          f"tiled step's (batch_tile={TRAIN_B // 2}) bit for bit; mass, "
          f"restitution, fric_coeff gradients within {e:.2e} of its "
          f"largest entry (tiled against itself: {e_self:.2e})")
    host = host_ms_in_turns(torch, train, 1)
    print(f"  (s2) ms per fwd+bwd in turns: "
          + "; ".join(f"{n} {', '.join(f'{x:.1f}' for x in v)}"
                      for n, v in host.items()) + f" ({smi})", flush=True)

    # (s3) the sharded inference demo at its defaults, then three epochs
    # on each mesh
    reset_counts()
    t0 = time.perf_counter()
    mass = si.main([])
    sec = time.perf_counter() - t0
    moved = {n: c for n, c in launch_counts().items() if c}
    check(abs(mass - si.TRUE_MASS) < 0.3,
          f"(s3) sharded_inference at its defaults on make_mesh() (256 "
          f"worlds, {si.STEPS} steps, 60 epochs, f32) recovers the mass "
          f"{mass:.4f} within 0.3 of {si.TRUE_MASS} "
          f"({1e3 * sec / 60:.0f} ms per epoch with the set-up; {smi})")
    check(not moved, f"(s3) its worlds stay off the floor over "
                     f"{si.STEPS} steps: contact-free, no solver kernel "
                     f"launched ({moved})")
    hist = []
    for mesh in (one, two):
        static, true_params, state0 = si.build_scene(f32, dev)
        states = si.randomized_states(state0, 256)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist.append(si.fit(static, true_params, states, mesh, 3))
        print(f"  (s3) 3 epochs on {mesh.size} shard(s): "
              f"{1e3 * (time.perf_counter() - t0) / 3:.0f} ms per epoch "
              f"with the ground truth", flush=True)
    # f32: the shards run the batched library calls at B = 128, the one
    # card at B = 256; the losses and gradients are means over the worlds
    e = max(abs(a / b - 1) for h1, h2 in zip(*hist)
            for a, b in zip(h1[:2], h2[:2]))
    check(e <= 1e-4, f"(s3) 3 epochs over [cuda:0, cuda:0]: losses and "
                     f"gradients within {e:.2e} (<= 1e-4) of "
                     f"make_mesh()'s")

    # (s4) the entry analogs
    fn, args = entry()
    reset_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    moved = {n: c for n, c in launch_counts().items() if c}
    check(out.p.shape == (4, 64, 3) and bool(torch.isfinite(out.p).all())
          and not moved,
          f"(s4) entry()'s step on the card: finite (4, 64, 3); the scene "
          f"is contact-free, no solver kernel launched ({moved})")
    reset_counts()
    l1, g1 = dryrun_multichip(1)
    l2, g2 = dryrun_multichip(2, devices=[dev, dev])
    moved = {n: c for n, c in launch_counts().items() if c}
    # identical worlds; means over 2 and 4 of them may round apart in
    # f32, and d loss / d mass is zero in exact arithmetic
    check(abs(l1 / l2 - 1) <= 1e-6 and max(g1, g2) <= 1e-5 and not moved,
          f"(s4) dryrun_multichip(1) and (2, [cuda:0, cuda:0]) agree: loss"
          f" {l1:.6f}, {l2:.6f}; grad|mass| {g1:.1e}, {g2:.1e} (round-off"
          f" of a zero gradient); contact-free, no solver kernel "
          f"launched ({moved})")
    return launches[2], launches["train"]


# ---------------------------------------------------------------------------
# The f32 physics-quality guard and big single worlds.
# ---------------------------------------------------------------------------

# the kernels each guard check's rollout must launch
GUARD_PATHS = {("bounce", "production"): ("fused_ipm",),
               ("bounce", "refine2"): ("lu", "solve"),
               ("stack", "production"): ("lu", "solve"),
               ("stack", "refine2"): ("lu", "solve"),
               ("free", "production"): ("gj_inv_blocked",),
               ("free", "refine2"): ("gj_inv_blocked",),
               ("dense", "production"): ("gj_inv_blocked",),
               ("dense", "refine2"): ("gj_inv_blocked",)}


def phase_guard(torch, dev, smi):
    """(v) The f32 physics-quality guard (lcp_physics_tpu_torch.tools.
    validate_f32) at full length at both profiles: each check's value,
    seconds and launches printed, then every one of the 8 must pass and
    each scene must have launched its kernels.  Returns the launch counts
    of the run."""
    from lcp_physics_tpu_torch.tools import validate_f32
    reset_counts()
    t0 = time.perf_counter()
    records = validate_f32.run_checks(str(dev))
    sec = time.perf_counter() - t0
    launches = launch_counts()
    for r in records:
        print(f"  {'PASS' if r['ok'] else 'FAIL'} {r['name']}: {r['detail']};"
              f" {r['seconds']:.1f} s ({1e3 * r['seconds'] / r['steps']:.1f} "
              f"ms/step); launches {r['launches']}", flush=True)
    check(len(records) == 8, "(v) the guard ran its 8 checks")
    for r in records:
        check(r["ok"], f"(v) {r['name']} at full length: {r['detail']}")
        need = GUARD_PATHS[(r["scene"], r["profile"])]
        check(all(r["launches"].get(k, 0) > 0 for k in need),
              f"(v) {r['name']} launched {need}: {r['launches']}")
    print(f"  (v) the guard took {sec:.1f} s ({smi})", flush=True)
    return launches


GRID_SPREAD = 4   # the kernels' grid penetration against the plain versions'


def hold_guard_grid(torch, dev, smi):
    """``--grid-hold``: the guard's production dense grid (500 steps
    through the kernels) held against float32 chaos on the card: the same
    rollout at p + 1 ulp through the kernels, and through the plain
    versions at p and at p + 1 ulp.  The kernels' two penetrations must be
    at most GRID_SPREAD times the larger of the plain versions' two.  The
    plain rollouts take ~400 s each, so the default run leaves it out."""
    from lcp_physics_tpu_torch.tools import validate_f32 as V
    rec = V.run_check("dense", "production", str(dev))
    print(f"  {rec['detail']}; {rec['seconds']:.1f} s; launches "
          f"{rec['launches']}", flush=True)
    pen = rec["value"]
    spec = V.dense_grid_spec()
    moved = spec._replace(p=ulp(spec.p))
    dt, steps, _ = V.LENGTHS["dense"]
    config = V.PROFILES["production"]

    def max_pen(sp):
        static, params, state = V.build(sp, torch.float32, dev)
        return V.run_scene(static, config, params, state, dt, steps)[3]

    t0 = time.perf_counter()
    pen_u = max_pen(moved)
    with plain_kernels("the dense grid's plain rollouts"):
        plain, plain_u = max_pen(spec), max_pen(moved)
    check(max(pen, pen_u) <= GRID_SPREAD * max(plain, plain_u),
          f"(v) dense grid [production], {steps} steps: max penetration "
          f"kernels {pen:.4f} (p + 1 ulp {pen_u:.4f}), plain versions on "
          f"the card {plain:.4f} (p + 1 ulp {plain_u:.4f}); the kernels' "
          f"within {GRID_SPREAD}x of plain's larger; "
          f"{time.perf_counter() - t0:.1f} s ({smi})")


BIG_CAP_N, BIG_CAP_C = 361, 768   # K2 = 1536: 12 panels, at the cap


def phase_bigworld(torch, dev, smi):
    """(g) Big single worlds (lcp_physics_tpu_torch.tools.bigworld): each
    of its configurations probed for bigworld.STEPS f32 steps, its record
    printed; K4 launched by every blocked one, and the K2 = 1600 case
    through the library LU with no K4.  Then the 12-panel path held to
    the plain versions: f64 at B = 2, one step with the IPM capped (K5 per
    panel), each world within 1e-8; f32 at B = 32, one full step, by
    distribution against plain's one-ulp spread.  Returns the launch
    counts of the probes and of the f64 step through the kernels."""
    from lcp_physics_tpu_torch.core import WorldState
    from lcp_physics_tpu_torch.ops import linalg
    from lcp_physics_tpu_torch.parallel import make_batched_step
    from lcp_physics_tpu_torch.tools import bigworld
    from lcp_physics_tpu_torch.utils import SimConfig
    reset_counts()
    for N_, B_, c_max, hulls, budget in bigworld.CONFIGS:
        rec = bigworld.probe(N_, B_, bigworld.STEPS, hulls=hulls,
                             hull_budget=budget, c_max=c_max, device=dev)
        final = rec.pop("final")
        shown = {k: (f"{v:.3f}" if isinstance(v, float) else v)
                 for k, v in rec.items()}
        print(f"  (g) {json.dumps(shown)} ({smi})", flush=True)
        check(bool(torch.isfinite(final.p).all()
                   and torch.isfinite(final.v).all()),
              f"(g) N={N_} B={B_} K2={rec['K2']}: the final state is finite")
        if rec["panels"]:
            check(rec["k4_per_step"] > 0,
                  f"(g) N={N_} K2={rec['K2']} ({rec['panels']} panels) "
                  f"launched K4, {rec['k4_per_step']:.1f} a step")
        if rec["K2"] > linalg.MAX_BLOCKED_N:
            check(rec["library_lu_per_step"] > 0 and rec["k4_per_step"] == 0,
                  f"(g) N={N_} K2={rec['K2']}: the library LU "
                  f"({rec['library_lu_per_step']:.1f} routings a step), no K4")
    launches = launch_counts()

    # the 12-panel path against the plain versions
    f32, f64 = torch.float32, torch.float64
    cap = SimConfig(max_iter=CAP_ITERS, solver_eps=0.0, solver_stall_lim=0)
    t0 = time.perf_counter()
    static, params, states = bigworld.build_grid_scene(
        BIG_CAP_N, 2, c_max=BIG_CAP_C, dtype=f64, device=dev)
    step = make_batched_step(static, cap)
    reset_counts()
    with torch.no_grad():
        s1, _ = step(params, states, bigworld.DT)
        held = launch_counts()
        with plain_kernels("the 12-panel f64 comparison step"):
            s1_r, _ = step(params, states, bigworld.DT)
    check(held["gj_inv"] > 0 and held["gj_inv_blocked"] == 0,
          f"(g) the f64 12-panel step launched K5 ({held['gj_inv']}), no K4")
    launches = {k: n + held[k] for k, n in launches.items()}
    e = world_rel(s1.v, s1_r.v)
    check(float(e.max()) <= 1e-8,
          f"(g) N={BIG_CAP_N} K2={2 * BIG_CAP_C} (12 panels) f64, one step "
          f"capped at {CAP_ITERS} IPM iterations: v kernel vs plain within "
          f"{float(e.max()):.2e} in every world (<= 1e-8); "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    static, params, states = bigworld.build_grid_scene(
        BIG_CAP_N, 32, c_max=BIG_CAP_C, dtype=f32, device=dev)
    step = make_batched_step(static, SimConfig(max_iter=12, solver_eps=1e-5))
    moved = WorldState(torch.tensor(ulp(states.p.cpu().numpy()), dtype=f32,
                                    device=dev), states.v, states.t)
    with torch.no_grad():
        s1, _ = step(params, states, bigworld.DT)
        with plain_kernels("the 12-panel f32 comparison steps"):
            s1_r, _ = step(params, states, bigworld.DT)
            s1_u, _ = step(params, moved, bigworld.DT)
    e, e_u = (world_rel(s.v, s1_r.v) for s in (s1, s1_u))
    check(float(e.median()) <= max(1e-5, 4 * float(e_u.median()))
          and share(e, 1e-3) >= share(e_u, 1e-3) - 0.05,
          f"(g) N={BIG_CAP_N} K2={2 * BIG_CAP_C} (12 panels) f32, B=32, one "
          f"step: v kernel vs plain, median world {float(e.median()):.2e}, "
          f"within 1e-3 on {share(e, 1e-3):.2%} (plain at p+1ulp: median "
          f"{float(e_u.median()):.2e}, within 1e-3 on {share(e_u, 1e-3):.2%})"
          f"; {time.perf_counter() - t0:.1f} s")
    return launches


def phase_turns(parent, smi):
    """The seven kernels of the checkout at ``parent`` and of this tree,
    device time, in turns parent, this, this, parent
    (tools/time_kernels.py, each tree in a process of its own)."""
    res = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                       "time_kernels.py"),
                          "--turns", parent], capture_output=True, text=True)
    check(res.returncode == 0, f"kernels of {parent} and of this tree timed "
                               f"in turns{res.stderr[-2000:]}")
    for line in res.stdout.strip().splitlines()[:-1]:
        print(f"  {line}", flush=True)


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port on one NVIDIA GPU.")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of an earlier commit: also time its "
                         "kernels and this tree's in turns")
    ap.add_argument("--grid-hold", action="store_true",
                    help="only hold the f32 guard's production dense grid "
                         "against the plain versions' one-ulp spread "
                         "(~15 min)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import lcp_physics_tpu_torch  # noqa: F401  (fails outside the repo)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def header(title):
        print(f"{title} [at {time.perf_counter() - t_start:.0f} s]",
              flush=True)

    header("== device")
    smi = phase_device(torch)
    if args.grid_hold:
        header("== (v) the guard's production dense grid against f32 chaos")
        hold_guard_grid(torch, dev, smi)
        return 0
    header("== kernels vs plain versions")
    stats = phase_lu(torch, dev)
    stats.update(phase_fused(torch, dev))
    stats.update(phase_fused(torch, dev, rot=False))
    stats.update(phase_gj(torch, dev))
    stats.update(phase_ipm_iter(torch, dev))
    for k, s in stats.items():
        lib = ("none" if s["library_ms"] is None
               else f"{s['library_ms']:.3f} ms")
        print(f"  {k}: {s['ms']:.4f} ms (plain {s['plain_ms']:.3f} ms, "
              f"library call {lib}, bound {s['bound_ms']:.4f} ms by "
              f"{s['bound_by']}) at its path's shape, device time", flush=True)
    if args.parent:
        header(f"== kernels of {args.parent} and of this tree in turns")
        phase_turns(args.parent, smi)
    header("== forward slice: batched 8-circle contact rollout")
    launches = phase_slice(torch, dev, smi)
    header("== training slice: dense 64-circle fwd+bwd")
    train32, train64 = phase_train(torch, dev, smi)
    header("== backward of the touching 8-circle line")
    phase_line(torch, dev, smi)
    header("== path (b): the dense forward through K6 (FUSE_ITER)")
    fuse_iter = phase_fuse_iter(torch, dev, smi)
    header("== path (a): the dense training step at solver_refine=1")
    phase_refine(torch, dev, smi)
    header("== path (c): the library API, lcp_solve(fric_pair=False), on "
           "the benchmark scene's LCPs")
    lcp_launches = phase_lcp(torch, dev, smi)
    header("== solver_stats at full width")
    phase_stats(torch, dev, smi)
    header("== the f64 JAX record of lcp_solve(fric_pair=False)")
    hold_lcp_record(torch, dev)
    header("== (h) the hull grid: bench.py's dense 64-square scene")
    phase_hull(torch, dev, smi)
    header("== (p) post-stabilization and the penetration backtrack")
    phase_stab(torch, dev, smi)
    header("== (w) the object layer: World, the demos")
    phase_world(torch, dev, smi)
    header("== (s) worlds sharded over a mesh, the sharded demo, the entry "
           "analogs")
    shard_launches, shard_train = phase_shard(torch, dev, smi)
    print(f"sharded path launches: forward slice {shard_launches}; "
          f"training step {shard_train}", flush=True)
    header("== (v) the f32 physics-quality guard at full length")
    guard = phase_guard(torch, dev, smi)
    header("== (g) big single worlds")
    big = phase_bigworld(torch, dev, smi)
    print(f"guard launches {guard}; big-world launches {big}", flush=True)
    header("== done")

    src = "lcp_physics_tpu_torch/csrc/"
    # each kernel's launches: its path's run, plus the guard's and the big
    # worlds' where they launch it
    rows = [("lu", src + "lu.cu", "lcp_physics_tpu/ops/linalg.py:113",
             (launches, guard, big)),
            ("solve", src + "lu.cu", "lcp_physics_tpu/ops/linalg.py:709",
             (launches, guard, big)),
            ("fused_ipm", src + "fused_ipm.cu",
             "lcp_physics_tpu/ops/ipm.py:108", (launches, guard, big)),
            ("fused_ipm_unrot", src + "fused_ipm.cu",
             "lcp_physics_tpu/ops/ipm.py:108", (lcp_launches,)),
            ("gj_inv_blocked", src + "gj_inv.cu",
             "lcp_physics_tpu/ops/linalg.py:238", (train32, guard, big)),
            ("gj_inv", src + "gj_inv.cu",
             "lcp_physics_tpu/ops/linalg.py:150", (train64, big)),
            ("ipm_iter", src + "ipm_iter.cu",
             "lcp_physics_tpu/ops/ipm_iter.py:102", (fuse_iter,))]
    kernels = [dict(name=name, route="cuda", source=source, replaces=rep,
                    launches=sum(c[name] for c in counts), **stats[name])
               for name, source, rep, counts in rows]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
