#!/usr/bin/env python3
"""Device time of the port's seven CUDA kernels at their paths' shapes.

    python tools/time_kernels.py                # this tree's kernels
    python tools/time_kernels.py --turns DIR    # DIR's tree and this one,
                                                # in turns DIR, this, this, DIR
    python tools/time_kernels.py --kernels      # the kernel table's columns

Each kernel is timed by ``cuda_ms`` (CUDA events around back-to-back
launches queued behind a sleep kernel, divided by the count, median of
three windows) on inputs made from fixed seeds at its path's shape: K1/K2
(trans 0 and 1) on (4096, 16, 16) f32 KKT matrices (the forward slice),
(4096, 24, 24) f32 (path (c)), (256, 56, 56) f64 (``LCPFunction``'s
dense KKT) and (4096, 88, 88) f32 and f64 (the largest lane size); K3 and K3u on 4096 engine-layout LCPs of
the forward slice's size (n = 24, C = 8: K = 16 rotated, 24 unrotated)
under its solver settings (max_iter 15, tol 1e-6, not_improved_lim 1), f32,
from the host's start (``initial_point``) and, as the solver runs them, from
their own (keys ``*_own``; "none" for a tree whose kernels take no such
start);
K4 on (256, 64, 64) f32 panels; K5 on (32, 128, 128) f64 panels and on
(256, 128, 128) f32 (``exact``, key ``gj_inv_f32``); K6 on the
dense scene's first-step LCP (B = 256, f32); and the blocked factor with
a solve pair (keys ``blocked_256`` and ``blocked_512``: a copy of K into
the buffer the factor takes over, the factor through K4, a solve at trans
0 and 1) on (1024, 256, 256) and (1024, 512, 512) f32 KKT matrices, the
training cells' systems.  The input generators are this
tree's ``tests/torch_inputs.py``; the kernels are those of the tree given by
``--root`` (default: this one), built into that tree at first use.
``--turns`` runs each tree in a process of its own and prints one line per
kernel with the four times and, last, a JSON object of them.

``--kernels`` prints the card's name and power limit, then one JSON line
``{"kernels": [...], "launches": {...}}``: for each kernel of the kernel
table (K1, K2 at trans 0 and 1, K3, K3u, K4, K5 and K6, at the shapes
above, K3/K3u from the given start, and the blocked factor with its
solve pair) its device ms, ``plain_ms`` (its plain torch version; for the
blocked factor the per-block transcription of the tests, through the same
panel kernel), ``library_ms`` (one PyTorch call computing the same
function, where there is one), ``bound_ms`` and ``bound_by`` (the call's
bytes, each read or written once, at the card's published bandwidth, or
its operations at the published FLOP/s, whichever is longer), ``x_bound``
(ms over bound_ms) and its launches on the main paths; and per main path
(the forward slice, the dense training step at f32 and f64, path (b) and
path (c), each run once with the counts zeroed just before) the launches
of every kernel.

Needs a CUDA device, and numpy, torch and pytest (the inputs module also
declares the tests' ``one_torch_thread`` fixture); also prints the card's
name and power limit.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (suffix, worlds, n, f64) of the K1/K2 shapes
LU_SHAPES = (("", 4096, 16, False), ("_24", 4096, 24, False),
             ("_56_f64", 256, 56, True), ("_88", 4096, 88, False),
             ("_88_f64", 4096, 88, True))
# worlds and rows of the blocked factor's shapes (the training cells' K2)
BLOCKED_SHAPES = ((1024, 256), (1024, 512))
NAMES = tuple(k + sfx for sfx, *_ in LU_SHAPES
              for k in ("lu", "solve", "solve_t")) + (
    "fused_ipm", "fused_ipm_unrot", "fused_ipm_own", "fused_ipm_unrot_own",
    "gj_inv_blocked", "gj_inv", "gj_inv_f32", "ipm_iter") + tuple(
    f"blocked_{n}" for _, n in BLOCKED_SHAPES)
# the kernel table's rows: the key of each kernel's path shape, and the shape
TABLE = {"lu": "(4096, 16, 16) f32", "solve": "(4096, 16) f32",
         "solve_t": "(4096, 16) f32",
         "fused_ipm": "4096 worlds, n = 24, C = 8, K = 16, f32",
         "fused_ipm_unrot": "4096 worlds, n = 24, C = 8, K = 24, f32",
         "gj_inv_blocked": "(256, 64, 64) f32",
         "gj_inv": "(32, 128, 128) f64",
         "ipm_iter": "the dense first step, B = 256, K2 = 256, f32",
         **{f"blocked_{n}": f"({B}, {n}, {n}) f32, a factor and two solves"
            for B, n in BLOCKED_SHAPES}}
# The H100 SXM's published peaks (NVIDIA's data sheet; full 700 W power
# limit): HBM3 bytes/s, and the highest FLOP/s for each item size without
# reduced precision: float32 outside the tensor cores, float64 on them.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}


def inputs():
    """This tree's tests/torch_inputs.py, imported by path (the package its
    functions drive is whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "torch_inputs", os.path.join(HERE, "tests", "torch_inputs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def iter_bound(inv, vecs, X):
    """K6's bound for one launch on which no world is done: the K2 x K2
    inverse block, Ghat, the vectors, X, bestX and the state read once, X,
    bestX and the state written once; 2 inverse matvecs (4 K2^2) and 4
    Ghat products (8 K2 n) per world."""
    B, K2, n = vecs[0].shape
    it = X.element_size()
    moved = (B * K2 * K2 * it + nbytes(*vecs) + 4 * nbytes(X)
             + 2 * B * 4 * it)
    return bound(moved, B * (4 * K2 * K2 + 8 * K2 * n), it)


def blocked_bound(B, n, itemsize):
    """The blocked factor and a solve pair's bound, T = n / 128 panels of
    P = 128: the panel inverses (2P^3 each) and the 128^3 products (2P^3
    each: sum (T-1-t) for Uhat's rows, sum (T-1-t)^2 for the trailing
    updates) at the card's FLOP/s, or its bytes at its bandwidth, K read
    and the factor (n x n and the T inverses) written once, each solve
    reading the factor and r and writing x once."""
    P = 128
    T = n // P
    blocks = sum(T - 1 - t + (T - 1 - t) ** 2 for t in range(T))
    flops = B * 2 * P ** 3 * (T + blocks)
    factor = B * (n * n + T * P * P) * itemsize
    moved = B * n * n * itemsize + factor + 2 * (factor + 2 * B * n * itemsize)
    return bound(moved, flops, itemsize)


def cases(torch, cs, dev):
    """(key, fn, more) for every kernel at its path's shape: fn() one call
    of the kernel (None for a tree without it), more() for a row of the
    kernel table (``TABLE``) the plain version's call, the library call
    (None where PyTorch has none) and the bound, else None.  Yields each
    case before it makes the next one's inputs."""
    from lcp_physics_tpu_torch.lcp.cone import ConeF
    from lcp_physics_tpu_torch.lcp.pdipm import _dtype_consts, initial_point
    from lcp_physics_tpu_torch.ops import _build, ipm, ipm_iter, linalg
    _build.load_all()
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(0)
    for sfx, B, n, f64_ in LU_SHAPES:
        dt = f64 if f64_ else f32
        K = torch.tensor(cs.kkt_batch(rng, B, n), dtype=dt, device=dev)
        r = torch.tensor(rng.standard_normal((B, n)), dtype=dt, device=dev)
        lu = linalg.plu_factor(K)
        yield "lu" + sfx, lambda: linalg.plu_factor(K), lambda: dict(
            plain=lambda: linalg.plu_factor_ref(K),
            library=lambda: torch.linalg.lu_factor(K, pivot=False),
            **bound(2 * nbytes(K), B * 2 * n ** 3 / 3, K.element_size()))

        def solve_more(trans):
            lu_l, piv = torch.linalg.lu_factor(K, pivot=False)
            return dict(
                plain=lambda: linalg.plu_solve_ref(lu, r, trans),
                library=lambda: torch.linalg.lu_solve(
                    lu_l, piv, r[..., None], adjoint=bool(trans)),
                **bound(2 * nbytes(r) + nbytes(lu), B * 2 * n * n,
                        K.element_size()))
        for trans, key in ((0, "solve"), (1, "solve_t")):
            yield (key + sfx, lambda: linalg.plu_solve(lu, r, trans),
                   lambda: solve_more(trans))
    for rot in (True, False):
        inst = cs.engine_instance(np.random.default_rng(0 if rot else 1), 4096,
                                  24, 8, 0, pair=rot, fd=2)
        qd, p, G, h, A, b, mu, valid, rmask = (
            torch.tensor(x, dtype=f32, device=dev) for x in inst)
        consts = _dtype_consts(f32)
        ops = (ipm.rot_operands if rot else ipm.unrot_operands)(qd, G, A, 8)
        x0 = initial_point(ops, p, h, b, ConeF(mu, valid, 2), rmask, consts,
                           fric_pair=rot)
        kw = dict(C=8, fd=2, consts=consts, fric_pair=rot, max_iter=15,
                  tol=1e-6, not_improved_lim=1)
        args = (ops, p, h, b, mu, valid, rmask, *x0)
        key = "fused_ipm" if rot else "fused_ipm_unrot"
        # the Schur system's rows: 2C rotated, (1 + fd)C unrotated
        Ks = 16 if rot else 24
        yield key, lambda: ipm.fused_ipm(*args, **kw), lambda: dict(
            plain=lambda: ipm.fused_ipm_ref(*args, **kw), library=None,
            **fused_bound(ops, args, ipm.fused_ipm(*args, **kw), 24, Ks))
        # the solver's path: the kernel taking its own start (a tree whose
        # kernel takes only a given start has no such time)
        try:
            ipm.fused_ipm(*args[:7], **kw)
        except TypeError:
            yield key + "_own", None, None
        else:
            yield key + "_own", lambda: ipm.fused_ipm(*args[:7], **kw), None
    for key, Bp, P, dt, f in (
            ("gj_inv_blocked", 256, 64, f32, "gj_inv_blocked"),
            ("gj_inv", 32, 128, f64, "gj_inv"),
            ("gj_inv_f32", 256, 128, f32, "gj_inv")):
        Pn = torch.tensor(cs.kkt_batch(rng, Bp, P), dtype=dt, device=dev)
        yield key, lambda: getattr(linalg, f)(Pn), lambda: dict(
            plain=lambda: getattr(linalg, f + "_ref")(Pn),
            library=lambda: torch.linalg.inv(Pn),
            **bound(2 * nbytes(Pn), Bp * 2 * P ** 3, Pn.element_size()))
    for B, n in BLOCKED_SHAPES:
        K = torch.tensor(cs.kkt_batch(rng, B, n), dtype=f32, device=dev)
        r = torch.tensor(rng.standard_normal((B, n)), dtype=f32, device=dev)
        Kw = torch.empty_like(K)
        try:   # the solver's call: its Schur matrix becomes the factor
            linalg.plu_factor(Kw.copy_(K), overwrite=True)
            factor = lambda: linalg.plu_factor(Kw, overwrite=True)
        except TypeError:   # a tree whose factor takes no ``overwrite``
            factor = lambda: linalg.plu_factor(Kw)

        def blocked():
            Kw.copy_(K)
            fac = factor()
            return linalg.plu_solve(fac, r, 0), linalg.plu_solve(fac, r, 1)

        def per_block():   # the factor a 128 x 128 block at a time
            fac = cs.per_block_factor(K)
            return cs.per_block_solve(fac, r, 0), cs.per_block_solve(fac, r, 1)

        def library():
            lu = torch.linalg.lu_factor(K)
            return (torch.linalg.lu_solve(*lu, r[..., None]),
                    torch.linalg.lu_solve(*lu, r[..., None], adjoint=True))
        yield f"blocked_{n}", blocked, lambda: dict(
            plain=per_block, library=library,
            **blocked_bound(B, n, K.element_size()))
    lcp = cs.first_step_lcp(torch, dev, f32, 256, 1)
    vecs, X0, fac, consts = cs.iter_operands(torch, lcp)
    n, m = vecs[2].shape[1], 4 * lcp["F"].C
    d_inv = torch.clamp(X0[:, n:n + m] / torch.clamp(
        X0[:, n + m:n + 2 * m], min=consts["tiny"]), consts["dinv_min"],
        consts["dinv_max"])
    a = (fac.iter_inv_raw(d_inv), *vecs, X0, X0,
         ipm_iter.initial_state(256, 12, f32, dev), 0)
    kw = dict(C=lcp["F"].C, consts=consts, tol=1e-5, not_improved_lim=1,
              stall_rtol=0.0)
    yield "ipm_iter", lambda: ipm_iter.iteration(*a, **kw), lambda: dict(
        plain=lambda: ipm_iter._iter_ref(*a, **kw), library=None,
        **iter_bound(a[0], vecs, X0))


def measure(torch, cs, dev):
    """{kernel: device ms per call} for the package on sys.path."""
    return {key: None if fn is None else cuda_ms(torch, fn)
            for key, fn, _ in cases(torch, cs, dev)}


def path_launches(torch, cs, dev):
    """{path: kernel launches} of the port's main paths, each built, then
    run once with the counts zeroed just before: the forward slice (B =
    4096, STEPS steps), the dense training step (B = 256 f32, TRAIN_B64
    worlds f64; TRAIN_STEPS steps, forward and backward), path (b) (the
    dense forward with ``FUSE_ITER`` set) and path (c) (``lcp_solve``'s
    forward and backward on the forward slice's LCPs)."""
    from lcp_physics_tpu_torch.core import rollout
    from lcp_physics_tpu_torch.lcp import pdipm
    from lcp_physics_tpu_torch.ops import ipm, ipm_iter, linalg
    f32, f64 = torch.float32, torch.float64

    def forward(step, params, state, n):
        with torch.no_grad():
            rollout(step, params, state, cs.DT, n)

    def slice_fwd():
        scene = cs.slice_scene(torch, dev, f32, *cs.slice_start(cs.B))
        return lambda: forward(*scene, cs.STEPS)

    def dense(dt, Bn, seed):
        return cs.train_scene(torch, dev, dt, *cs.grid_start(
            Bn, cs.TRAIN_SIDE, seed), cs.TRAIN_C)

    def train(dt, Bn, seed):
        scene = dense(dt, Bn, seed)
        return lambda: cs.train_step(torch, *scene, cs.TRAIN_STEPS)

    def fuse_iter():
        scene = dense(f32, cs.TRAIN_B, 1)

        def run():
            pdipm.FUSE_ITER = True
            try:
                forward(*scene, cs.TRAIN_STEPS)
            finally:
                pdipm.FUSE_ITER = False
        return run

    def lcp():
        blocks = cs.slice_lcp(torch, dev, f32)
        return lambda: cs.lcp_fwd_bwd(torch, blocks, fric_pair=False,
                                      **cs.LCP_KW)
    out = {}
    for name, build in (("forward_slice", slice_fwd),
                        ("train", lambda: train(f32, cs.TRAIN_B, 1)),
                        ("train_f64", lambda: train(f64, cs.TRAIN_B64, 2)),
                        ("fuse_iter", fuse_iter), ("lcp", lcp)):
        run = build()
        torch.cuda.synchronize()
        for counts in (linalg.LAUNCHES, ipm.LAUNCHES, ipm_iter.LAUNCHES):
            for k in counts:
                counts[k] = 0
        run()
        torch.cuda.synchronize()
        out[name] = cs.launch_counts()
    return out


def table(torch, cs, dev):
    """The kernel table's rows: per kernel of ``TABLE`` its device ms, the
    plain version's, the library call's, the bound and the launches on the
    main paths (``path_launches``, summed)."""
    launches = path_launches(torch, cs, dev)
    rows = []
    for key, fn, more in cases(torch, cs, dev):
        if key not in TABLE:
            continue
        m = more()
        plain, lib = m.pop("plain"), m.pop("library")
        ms = cuda_ms(torch, fn)
        rows.append(dict(
            name=key, shape=TABLE[key], ms=ms, plain_ms=cuda_ms(torch, plain),
            library_ms=None if lib is None else cuda_ms(torch, lib),
            **m, x_bound=ms / m["bound_ms"],
            launches=sum(c.get(key, 0) for c in launches.values())))
    return dict(kernels=rows, launches=launches)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run_tree(root):
    """measure() in a process of its own on the tree at root."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                          root], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="tree whose kernels are timed (default: this one)")
    ap.add_argument("--turns", metavar="DIR",
                    help="time DIR's tree and this one in turns")
    ap.add_argument("--kernels", action="store_true",
                    help="print the kernel table's columns: ms, plain_ms, "
                         "library_ms, the bound and the paths' launches")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    card = smi()
    if args.turns:
        order = [("parent", args.turns), ("this", HERE), ("this", HERE),
                 ("parent", args.turns)]
        times = {"parent": [], "this": []}
        for tag, root in order:
            times[tag].append(run_tree(os.path.abspath(root)))
        ms = lambda t: "none" if t is None else f"{t:.4f}"
        for k in NAMES:
            old = ", ".join(ms(t.get(k)) for t in times["parent"])
            new = ", ".join(ms(t.get(k)) for t in times["this"])
            print(f"{k}: parent {old} ms; this tree {new} ms (device time, "
                  f"in turns parent, this, this, parent; {card})", flush=True)
        print(json.dumps({"card": card, **times}), flush=True)
        return 0
    sys.path.insert(0, os.path.abspath(args.root))
    dev = torch.device("cuda", 0)
    if args.kernels:
        print(card, flush=True)
        print(json.dumps(table(torch, inputs(), dev)), flush=True)
        return 0
    print(json.dumps(measure(torch, inputs(), dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
