"""FLOP and byte accounting of the dense step's components on the card
(counterpart of the repository's ``tools/roofline.py``).

The bench's dense 64-circle grid (``tools.bench.build_world_scene(dense=
True)``; B = 256 worlds, n = 192 dofs, C = 128 contact slots, m = 4C = 512
LCP rows, K = 2C = 256 rotated Schur rows, panels of P = 128) is split
into the components of its hot path, each timed by the bench's window
timer, all components in turns (``tools.bench.time_turns``; host clock,
CUDA events beside it), and set against analytic FLOP and byte counts (``counts``):

* narrowphase: ``core.geometry.find_contacts`` over the 2016 circle pairs;
* assembly: ``make_assemble``'s blocks (narrowphase included);
* factor with the P-plane: ``make_kkt_factor`` (which forms
  P2 = Ghat2 Q^-1 Ghat2^T) and its blocked LU with the Gauss-Jordan
  panel inverses, taken as the factor plus one solve less the marginal
  solve (the factor plus two solves, less the factor plus one);
* one KKT solve;
* the residual pair r_x = Q z + p + G^T lam, r_z = G z + F lam - h;
* the whole batched step (time only), beside one iteration's sum.

The counts are the JAX tool's formulas (tools/roofline.py:134-153)
without its ``* 3`` pass factors in the P-plane, the solve and the
residuals: those count the TPU's three bfloat16 passes that emulate one
float32 product, not work.  Peaks are the H100 SXM's (NVIDIA's data
sheet, at the full 700 W): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32
outside the tensor cores; TF32 is off in the port, so float32 products
run at that rate.  The card's name and power limit are printed beside
them.

Usage: ``python -m lcp_physics_tpu_torch.tools.roofline [--device
cuda|cpu]``.  The default is the card; without one it raises.
"""
from __future__ import annotations

import argparse
import sys

import torch

from lcp_physics_tpu_torch.core import find_contacts, make_assemble
from lcp_physics_tpu_torch.lcp import lcp_solve_full, pdipm
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.tools import bench
from lcp_physics_tpu_torch.utils import SimConfig

PEAK_BYTES = 3.35e12    # bytes/s, H100 SXM HBM3
PEAK_FLOPS = 67e12      # FLOP/s, H100 SXM float32 outside the tensor cores
VERDICT_SLACK = 1.6     # within this factor of its bound a call is bound


def counts(B, n, m, K, P):
    """Analytic FLOPs and bytes a batch of B worlds (a multiply-add is 2
    FLOPs; float32, 4 bytes): {component: (flops, bytes)} for
    ``pplane``, ``factor``, ``solve``, ``resid``, ``narrow`` and
    ``assembly`` (tools/roofline.py:134-153 and :164-165, the 3-pass
    factors removed).  ``narrow`` counts the N(N - 1)/2 circle pairs of
    N = n / 3 bodies at 40 FLOPs a pair."""
    pairs = (n // 3) * (n // 3 - 1) // 2
    c = {
        # Ghat (B, K, n) x diag x Ghat^T -> (B, K, K)
        "pplane": (B * 2 * K * K * n, B * 4 * (2 * K * n + K * K)),
        # blocked LU over K / P panels: a GJ inverse ~2P^3 a diagonal
        # panel, the elimination ~(2/3)K^3; read S, write the factor
        "factor": (B * ((2 / 3) * K ** 3 + (K // P) * 2 * P ** 3),
                   B * 4 * 2 * K * K),
        # two triangular substitutions (4K^2), the rhs and solution
        # transforms against Ghat (4Kn)
        "solve": (B * (4 * K * K + 4 * K * n),
                  B * 4 * (2 * K * K + 2 * K * n)),
        # G^T lam and G z, the cone matvec
        "resid": (B * (2 * 2 * m * n + 6 * m), B * 4 * (m * n + 2 * (m + n))),
        "narrow": (B * pairs * 40, B * 4 * (pairs * 8)),
    }
    c["assembly"] = (c["narrow"][0] + B * 2 * m * n // 8,
                     c["narrow"][1] + B * 4 * m * n // 4)
    return c


def verdict(ms, flops, nbytes):
    """(TFLOP/s achieved, % of the FP32 peak, bytes-bound ms, FLOP-bound
    ms, what bounds the call): a call within VERDICT_SLACK of its larger
    bound is bound by it, else by latency and overhead."""
    t_b, t_f = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_FLOPS
    if ms < VERDICT_SLACK * max(t_b, t_f):
        what = "operations" if t_f > t_b else "bytes"
    else:
        what = (f"latency/overhead ({100 * (ms - max(t_b, t_f)) / ms:.0f}% "
                f"unexplained)")
    return (flops / ms / 1e9, 100 * flops / (ms / 1e3) / PEAK_FLOPS, t_b, t_f,
            what)


def measure(B=256, device="cuda", calls=20, windows=bench.WINDOWS):
    """Time each component on the dense scene.  Returns (shape, rows,
    step): shape (B, n, m, K, P), rows [(name, timing of
    ``time_turns`` or derived (host, event) ms, flops, bytes)], step the
    whole batched step's timing with the mean IPM iterations of its
    first LCP."""
    static, params, states = bench.build_world_scene(B, dense=True,
                                                     device=device)
    config = SimConfig(**bench.WORLD_CONFIG)
    assemble, _ = make_assemble(static, config)
    N, C = static.n_bodies, static.c_max
    n, m, K, P = 3 * N, 4 * C, 2 * C, 128
    dt_w = torch.full((B,), bench.DT, dtype=states.p.dtype, device=device)
    with torch.no_grad():
        blocks, _ = assemble(params, states, dt_w)
        args = [blocks[k] for k in ("Q", "p", "G", "h", "A", "b", "F")]
        sol = lcp_solve_full(*args, q_is_diag=True, gamma_rows=C,
                             row_mask=blocks["row_mask"], max_iter=8,
                             tol=1e-5, fric_pair=True)
    Q, p, G, h, A, _, F = args
    d_inv = torch.clamp(sol.s / torch.clamp(sol.lam, min=1e-30), 1e-6, 1e6)
    rhs = torch.cat([p, h], -1)
    z_lam = torch.cat([sol.z, sol.lam], -1)
    reg = pdipm._dtype_consts(p.dtype)["reg"]

    def make_fac():
        return pdipm.make_kkt_factor(Q, Q, G, A, F, reg, "auto",
                                     gamma_rows=C, fric_pair=True)

    def factor_solve1():
        return make_fac()(d_inv)(rhs, 0)

    def factor_solve2():
        s = make_fac()(d_inv)
        y1 = s(rhs, 0)
        return s(rhs + 0.1 * y1, 0)        # dependent, as in Mehrotra

    def residuals():
        z, lam = z_lam[:, :n], z_lam[:, n:]
        rx = Q * z + p + torch.einsum("bmn,bm->bn", G, lam)
        rz = torch.einsum("bmn,bn->bm", G, z) + F.matvec(lam) - h
        return rx, rz

    pairs = static.pair_lists()
    counts_np = static.counts_np()
    bstep = make_batched_step(static, config)
    parts = {"narrowphase": lambda: find_contacts(
                 states.p, params.verts, params.radius, counts_np, pairs, C),
             "assembly": lambda: assemble(params, states, dt_w)[0],
             "factor+1 solve": factor_solve1,
             "factor+2 solves": factor_solve2,
             "residuals": residuals,
             "step": lambda: bstep(params, states, bench.DT)[0]}
    with torch.no_grad():
        t = bench.time_turns(parts, device, calls, windows)
    for v in t.values():
        v.pop("out")
    one = {k: t["factor+2 solves"][k] - t["factor+1 solve"][k]
           for k in ("host_ms", "event_ms")
           if t["factor+1 solve"][k] is not None}
    fac = {k: t["factor+1 solve"][k] - one[k] for k in one}
    c = counts(B, n, m, K, P)
    rows = [("narrowphase", t["narrowphase"], *c["narrow"]),
            ("assembly (all)", t["assembly"], *c["assembly"]),
            ("factor (+P-plane)", fac, c["factor"][0] + c["pplane"][0],
             c["factor"][1] + c["pplane"][1]),
            ("kkt solve (x1)", one, *c["solve"]),
            ("residuals", t["residuals"], *c["resid"])]
    step = dict(t["step"], iters=float(sol.iters.double().mean()),
                per_iter={k: fac[k] + 2 * one[k] + t["residuals"][k]
                          for k in one})
    return (B, n, m, K, P), rows, step


def lines(shape, rows, step):
    """The report: a markdown table on the host clock (the event ms beside
    each row) and the whole step.  Off the card (no event times) the
    achieved rates and the bound are "not measured"."""
    B, n, m, K, P = shape
    card = step["event_ms"] is not None
    out = [f"[roofline] dense circle scene: B={B} n={n} m={m} K_rot={K} "
           f"P={P}; peaks {PEAK_BYTES / 1e12:.2f} TB/s, "
           f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s FP32 (TF32 off)",
           "[roofline] component | host ms/call | event ms/call | GFLOP/call"
           " | TFLOP/s | % FP32 peak | MB/call | bytes-ms | FLOP-ms | bound"]
    for name, t, flops, nbytes in rows:
        ms = t["host_ms"]
        tf, pct, t_b, t_f, what = verdict(ms, flops, nbytes)
        ev, got = ((f"{t['event_ms']:.3f}", f"{tf:.3f} | {pct:.2f}%")
                   if card else ("not measured", "not measured | "
                                 "not measured"))
        out.append(f"[roofline] {name} | {ms:.3f} | {ev} | "
                   f"{flops / 1e9:.2f} | {got} | {nbytes / 1e6:.1f} | "
                   f"{t_b:.4f} | {t_f:.4f} | "
                   f"{what if card else 'not measured'}")
    ev = f"{step['event_ms']:.2f} ms" if card else "not measured"
    per = step["per_iter"]["host_ms"]
    out.append(f"[roofline] full batched step: host {step['host_ms']:.2f} ms"
               f", events {ev} ({B / (step['host_ms'] / 1e3):,.0f} world-"
               f"steps/s); IPM iterations ~{step['iters']:.1f} on its first "
               f"LCP; one iteration (factor + 2 solves + residuals) "
               f"{per:.2f} ms host; launches a step {step['launches']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu is for tests; the default is the card")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("roofline: no CUDA device")
    bench.log(f"[roofline] {bench.device_line(args.device)}")
    for line in lines(*measure(device=args.device)):
        bench.log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
