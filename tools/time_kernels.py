#!/usr/bin/env python3
"""Device time of the port's seven CUDA kernels at their paths' shapes.

    python tools/time_kernels.py                # this tree's kernels
    python tools/time_kernels.py --turns DIR    # DIR's tree and this one,
                                                # in turns DIR, this, this, DIR

Each kernel is timed as ``chip_smoke.py`` times it (``cuda_ms``: CUDA
events around back-to-back launches, divided by the count, median of three
windows) on inputs made from fixed seeds at its path's shape: K1/K2
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
dense scene's first-step LCP (B = 256, f32).  The input generators are this
tree's ``chip_smoke.py``; the kernels are those of the tree given by
``--root`` (default: this one), built into that tree at first use.
``--turns`` runs each tree in a process of its own and prints one line per
kernel with the four times and, last, a JSON object of them.  Needs a CUDA
device; also prints the card's name and power limit.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (suffix, worlds, n, f64) of the K1/K2 shapes
LU_SHAPES = (("", 4096, 16, False), ("_24", 4096, 24, False),
             ("_56_f64", 256, 56, True), ("_88", 4096, 88, False),
             ("_88_f64", 4096, 88, True))
NAMES = tuple(k + sfx for sfx, *_ in LU_SHAPES
              for k in ("lu", "solve", "solve_t")) + (
    "fused_ipm", "fused_ipm_unrot", "fused_ipm_own", "fused_ipm_unrot_own",
    "gj_inv_blocked", "gj_inv", "gj_inv_f32", "ipm_iter")


def smoke():
    """This tree's chip_smoke.py, imported by path (the package it drives
    is whichever tree is first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(torch, cs, dev):
    """{kernel: device ms per call} for the package on sys.path."""
    from lcp_physics_tpu_torch.lcp.cone import ConeF
    from lcp_physics_tpu_torch.lcp.pdipm import _dtype_consts, initial_point
    from lcp_physics_tpu_torch.ops import _build, ipm, ipm_iter, linalg
    _build.load_all()
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(0)
    out = {}
    for sfx, B, n, f64_ in LU_SHAPES:
        dt = f64 if f64_ else f32
        K = torch.tensor(cs.kkt_batch(rng, B, n), dtype=dt, device=dev)
        r = torch.tensor(rng.standard_normal((B, n)), dtype=dt, device=dev)
        lu = linalg.plu_factor(K)
        out["lu" + sfx] = cs.cuda_ms(torch, lambda: linalg.plu_factor(K))
        for trans, key in ((0, "solve"), (1, "solve_t")):
            out[key + sfx] = cs.cuda_ms(
                torch, lambda: linalg.plu_solve(lu, r, trans))
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
        out[key] = cs.cuda_ms(torch, lambda: ipm.fused_ipm(*args, **kw))
        # the solver's path: the kernel taking its own start (a tree whose
        # kernel takes only a given start has no such time)
        try:
            ipm.fused_ipm(*args[:7], **kw)
        except TypeError:
            out[key + "_own"] = None
        else:
            out[key + "_own"] = cs.cuda_ms(
                torch, lambda: ipm.fused_ipm(*args[:7], **kw))
    P4 = torch.tensor(cs.kkt_batch(rng, 256, 64), dtype=f32, device=dev)
    out["gj_inv_blocked"] = cs.cuda_ms(torch, lambda: linalg.gj_inv_blocked(P4))
    P5 = torch.tensor(cs.kkt_batch(rng, 32, 128), dtype=f64, device=dev)
    out["gj_inv"] = cs.cuda_ms(torch, lambda: linalg.gj_inv(P5))
    P5s = torch.tensor(cs.kkt_batch(rng, 256, 128), dtype=f32, device=dev)
    out["gj_inv_f32"] = cs.cuda_ms(torch, lambda: linalg.gj_inv(P5s))
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
    out["ipm_iter"] = cs.cuda_ms(torch, lambda: ipm_iter.iteration(*a, **kw))
    return out


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
    print(json.dumps(measure(torch, smoke(), dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
