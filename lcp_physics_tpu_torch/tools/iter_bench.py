"""Per-iteration costs of the IPM on the dense scene (counterpart of the
repository's ``tools/iter_bench.py``).

The LCP of the first step of the bench's dense 64-circle grid
(``tools.bench.build_world_scene(dense=True)``, B = 256, c_max = 128, so
the rotated Schur system has K2 = 256 rows, two 128-panels) is split into
the parts one interior-point iteration pays, each timed by the bench's
window timer, all parts in turns (``tools.bench.time_turns``: host
clock, CUDA events beside it), on the factor of
``lcp.pdipm.make_kkt_factor``:

* the factor against the per-solve marginal: the factor plus one solve
  and the factor plus two solves (the difference is one solve);
* ``solve.reduced`` + ``solve.z_from``: once, and with a second
  ``reduced(r1_zero=True)`` (the marginal of a reduced solve);
* the residual pair ``factor.residual_ops`` (G z | A z and G^T lam +
  A^T nu over Ghat2);
* the explicit-inverse build ``factor.iter_inv_raw``, which the fused
  per-iteration kernel K6 needs and the unfused loop does not.

With ``--sweep``, ``lcp_solve`` at ``max_iter`` 1, 3 and 7 with ``tol=0``
and ``not_improved_lim=0`` (every world runs exactly ``max_iter``
iterations), with ``lcp.pdipm.FUSE_ITER`` off (the unfused loop over the
blocked LU) and on (K6 against the explicit inverse), the six solves
timed in turns: the marginal ms per iteration and the intercept of each,
the line fitted by least squares.  The flag is restored after.

The JAX tool also times the inverse's (1, 2, 0) lane transpose; that is
the TPU's layout for its kernel and has no counterpart here.

Usage: ``python -m lcp_physics_tpu_torch.tools.iter_bench [--sweep]
[--device cuda|cpu]``.  The default is the card; without one it raises.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from lcp_physics_tpu_torch.core import make_assemble
from lcp_physics_tpu_torch.lcp import lcp_solve, pdipm
from lcp_physics_tpu_torch.tools import bench
from lcp_physics_tpu_torch.utils import SimConfig

SWEEP_ITERS = (1, 3, 7)


def dense_lcp(B=256, device="cuda"):
    """The dense scene's first-step LCP blocks (``make_assemble`` under
    SimConfig(max_iter=12, solver_eps=1e-5)) and its c_max."""
    static, params, states = bench.build_world_scene(B, dense=True,
                                                     device=device)
    assemble, _ = make_assemble(static, SimConfig(**bench.WORLD_CONFIG))
    with torch.no_grad():
        blocks, _ = assemble(params, states, torch.full(
            (B,), bench.DT, dtype=states.p.dtype, device=device))
    return blocks, static.c_max


def _marginal(t1, t2):
    """(ms of one more call, ms of the rest), each (host, event), from the
    timings of one call and of two."""
    def diff(key):
        a, b = t1[key], t2[key]
        return (None, None) if a is None else (b - a, 2 * a - b)
    host, event = diff("host_ms"), diff("event_ms")
    return (host[0], event[0]), (host[1], event[1])


def components(blocks, C, device="cuda", calls=20, windows=bench.WINDOWS):
    """Each component's timing dict (``tools.bench.time_turns``) under its
    label, and the derived (host, event) ms: ``one solve`` and ``factor``
    from the factor plus one and plus two solves, ``marginal reduced``
    from one and two reduced solves."""
    Q, p, G, A, F = (blocks[k] for k in "Q p G A F".split())
    B, n = p.shape
    m, q = G.shape[-2], A.shape[-2]
    opts = dict(dtype=p.dtype, device=device)
    reg = pdipm._dtype_consts(p.dtype)["reg"]
    kkt = pdipm.make_kkt_factor(Q, Q, G, A, F, reg, "auto", gamma_rows=C,
                                refine=0, fric_pair=True)
    rng = np.random.default_rng(0)
    d_inv = torch.tensor(rng.uniform(0.5, 2.0, (B, m)), **opts)
    rhs1 = torch.tensor(rng.standard_normal((B, n + m + q)), **opts)
    rhs2 = torch.tensor(rng.standard_normal((B, n + m + q)), **opts)

    def fac_k_solves(k):
        def f():
            solve = kkt(d_inv)
            out = solve(rhs1)
            if k > 1:
                out = out + solve(rhs2)
            return out
        return f

    def red_k(k):
        def f():
            solve = kkt(d_inv)
            w, wk = solve.reduced(rhs1)
            if k > 1:
                w2, wk2 = solve.reduced(rhs2, r1_zero=True)
                w, wk = w + w2, wk + wk2
            return w, solve.z_from(rhs1[:, :n], wk)
        return f

    down, up = kkt.residual_ops
    zv = torch.tensor(rng.standard_normal((B, n)), **opts)
    lamv = torch.tensor(rng.uniform(0.1, 1.0, (B, m)), **opts)
    nuv = torch.tensor(rng.standard_normal((B, q)), **opts)
    parts = {"factor+1 solve": fac_k_solves(1),
             "factor+2 solves": fac_k_solves(2),
             "factor+reduced+z_from": red_k(1),
             "factor+2 reduced+z_from": red_k(2),
             "residual down+up": lambda: (down(zv), up(lamv, nuv)),
             "inverse build (iter_inv_raw)": lambda: kkt.iter_inv_raw(d_inv)}
    with torch.no_grad():
        out = bench.time_turns(parts, device, calls, windows)
    for t in out.values():
        t.pop("out")
    out["one solve"], out["factor"] = _marginal(out["factor+1 solve"],
                                                out["factor+2 solves"])
    out["marginal reduced"] = _marginal(out["factor+reduced+z_from"],
                                        out["factor+2 reduced+z_from"])[0]
    return out


def _fit(iters, ms):
    """Least-squares line through (max_iter, ms): (ms an iteration,
    intercept)."""
    x, y = np.asarray(iters, float), np.asarray(ms, float)
    slope = float(((x - x.mean()) * (y - y.mean())).sum()
                  / ((x - x.mean()) ** 2).sum())
    return slope, float(y.mean() - slope * x.mean())


def sweep(blocks, C, device="cuda", calls=5, windows=bench.WINDOWS,
          iters=SWEEP_ITERS):
    """``lcp_solve`` at each ``max_iter`` of ``iters`` (tol 0, stall rule
    off), FUSE_ITER off and on, all timed in turns: {fuse: {"runs":
    {max_iter: timing}, "marginal": (host, event) ms an iteration,
    "intercept": (host, event) ms}}, the line fitted by least squares.
    The flag is restored after."""
    args = [blocks[k] for k in ("Q", "p", "G", "h", "A", "b", "F")]

    def solver(fuse, mi):
        def solve():
            pdipm.FUSE_ITER = fuse
            with torch.no_grad():
                return lcp_solve(*args, max_iter=mi, tol=0.0, gamma_rows=C,
                                 row_mask=blocks["row_mask"],
                                 not_improved_lim=0, fric_pair=True)
        return solve

    saved = pdipm.FUSE_ITER
    try:
        t = bench.time_turns({(f, mi): solver(f, mi) for f in (False, True)
                              for mi in iters}, device, calls, windows)
    finally:
        pdipm.FUSE_ITER = saved
    res = {}
    for fuse in (False, True):
        runs = {mi: t[(fuse, mi)] for mi in iters}
        for r in runs.values():
            r.pop("out")
        host = _fit(iters, [runs[mi]["host_ms"] for mi in iters])
        event = ((None, None) if runs[iters[0]]["event_ms"] is None else
                 _fit(iters, [runs[mi]["event_ms"] for mi in iters]))
        res[fuse] = dict(runs=runs, marginal=(host[0], event[0]),
                         intercept=(host[1], event[1]))
    return res


def _ms(pair):
    host, event = pair
    ev = "not measured" if event is None else f"{event:.3f} ms"
    return f"host {host:.3f} ms, events {ev}"


def lines(comp, swept=None):
    """The report's lines for ``components``' and ``sweep``'s results."""
    out = []
    for label, t in comp.items():
        if isinstance(t, dict):
            out.append(f"[iter_bench] {label}: "
                       f"{_ms((t['host_ms'], t['event_ms']))}; launches a "
                       f"call {t['launches']}")
        else:
            out.append(f"[iter_bench] -> {label}: {_ms(t)}")
    for fuse, r in (swept or {}).items():
        for mi, t in r["runs"].items():
            out.append(f"[iter_bench] FUSE_ITER={fuse} max_iter={mi}: "
                       f"{_ms((t['host_ms'], t['event_ms']))} a solve batch;"
                       f" launches a call {t['launches']}")
        out.append(f"[iter_bench] FUSE_ITER={fuse}: marginal "
                   f"{_ms(r['marginal'])} an iteration, intercept "
                   f"{_ms(r['intercept'])}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep max_iter with FUSE_ITER off and on")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu is for tests; the default is the card")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("iter_bench: no CUDA device")
    bench.log(f"[iter_bench] {bench.device_line(args.device)}")
    blocks, C = dense_lcp(device=args.device)
    B, n = blocks["p"].shape
    bench.log(f"[iter_bench] dense scene: B={B} n={n} "
              f"m={blocks['h'].shape[-1]} q={blocks['b'].shape[-1]} "
              f"K2={2 * C + blocks['b'].shape[-1]}")
    comp = components(blocks, C, args.device)
    swept = sweep(blocks, C, args.device) if args.sweep else None
    for line in lines(comp, swept):
        bench.log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
