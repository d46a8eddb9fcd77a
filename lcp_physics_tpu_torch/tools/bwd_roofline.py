"""Where the backward of the dense training step goes (counterpart of the
repository's ``tools/bwd_roofline.py``).

The training step of the bench's ``fwd_bwd_dense`` row: mean(p^2) and its
gradients through ``N_STEPS`` = 8 steps of the dense 64-circle grid
(``tools.bench.build_world_scene(dense=True)``, B = 256, c_max = 128,
SimConfig(max_iter=12, solver_eps=1e-5), float32; the rotated Schur
system K2 = 256 in two 128-panels).  Its parts, each timed by the bench's
window timer (``tools.bench.time_turns``: host clock, CUDA events beside
it, launches a call), compared parts in turns:

  fwd            mean(p^2) after 8 steps, without grad (``bench._steps``)
  fwd+bwd        the row's own function, ``bench._fwd_bwd``
  rollout        ``core.rollout`` fwd+bwd, remat=False, in turns with
  remat          the same with remat=True (a step's forward recomputed in
                 the backward, ``torch.utils.checkpoint``)
  step           one step's forward
  step-vjp       one step's pullback: its forward once, then
                 ``torch.autograd.grad(retain_graph=True)`` with ones
                 cotangents on (p, v), to every float leaf of params and
                 state ("linearize once, pull many")
  lcp-bwd        ``lcp.lcp._lcp_bwd_impl`` on the first step's blocks and
                 their ``lcp_solve_full`` solution, g = ones
  bwd factor     ``make_kkt_factor`` plus one trans=1 solve, and plus two
  bwd solve      solves: the marginal splits them (``iter_bench._marginal``)
  outers         the cotangent outer products (dQ, dp, dG, dh, dA, db,
                 dF) given w
  asm, asm-vjp   the assembly forward, and its pullback with ones
                 cotangents on Q, p, G, h and F.mu

Then "known per step" (lcp-bwd + asm-vjp), "measured per step" ((fwd+bwd
- fwd) / 8, beside the one-step VJP) and the unexplained rest.

The JAX tool runs its backward factor under the ``'highest'`` matmul
precision.  The port has no such knob (every float32 product is full
float32, TF32 off): its backward factor runs at the forward's
``factor_precision`` (None, so the rank-16 panel kernel K4 inverts each
128-panel, two launches a panel), which the launches column shows.

Usage: ``python -m lcp_physics_tpu_torch.tools.bwd_roofline [--device
cuda|cpu]``.  The default is the card; without one it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from lcp_physics_tpu_torch.core import WorldState, make_assemble, rollout
from lcp_physics_tpu_torch.lcp import lcp_solve_full, pdipm
from lcp_physics_tpu_torch.lcp.lcp import _lcp_bwd_impl
from lcp_physics_tpu_torch.lcp.util import bger
from lcp_physics_tpu_torch.parallel import make_batched_step
from lcp_physics_tpu_torch.tools import bench
from lcp_physics_tpu_torch.tools.iter_bench import _marginal
from lcp_physics_tpu_torch.utils import SimConfig

N_STEPS = 8
PARAM_LEAVES = ("mass", "inertia", "restitution", "fric_coeff", "radius",
                "verts", "gravity")
STATE_LEAVES = ("p", "v", "t")


def dense_scene(B=256, device="cuda", dtype=bench.F32):
    """The bench's dense grid and its SimConfig: (static, params, states,
    config)."""
    static, params, states = bench.build_world_scene(
        B, dense=True, dtype=dtype, device=device)
    return static, params, states, SimConfig(**bench.WORLD_CONFIG)


def leaf(x):
    """A copy of x that is a fresh leaf requiring grad."""
    return x.detach().clone().requires_grad_(True)


def with_leaves(params, states):
    """Copies of params and states whose float tensors are fresh leaves
    that require grad, and those leaves (params' ``PARAM_LEAVES``, then
    the state's ``STATE_LEAVES``)."""
    pr = dataclasses.replace(params, **{f: leaf(getattr(params, f))
                                        for f in PARAM_LEAVES})
    st = WorldState(*(leaf(getattr(states, f)) for f in STATE_LEAVES))
    return pr, st, [getattr(pr, f) for f in PARAM_LEAVES] + [
        getattr(st, f) for f in STATE_LEAVES]


def pullback(outs, leaves):
    """fn() pulling ones cotangents on the outputs that carry a graph back
    to ``leaves`` (None where a leaf is not reached); the graph is kept,
    so fn can be called again."""
    outs = [o for o in outs if o.requires_grad]
    ones = [torch.ones_like(o) for o in outs]
    return lambda: torch.autograd.grad(outs, leaves, ones, retain_graph=True,
                                       allow_unused=True)


def dt_worlds(states):
    B = states.p.shape[0]
    return torch.full((B,), bench.DT, dtype=states.p.dtype,
                      device=states.p.device)


def first_step_lcp(static, config, params, states):
    """The first step's LCP blocks (no grad) and their ``lcp_solve_full``
    solution, solved as the JAX tool solves them (its ``max_iter`` and
    ``tol``, ``fric_pair=True``)."""
    assemble, _ = make_assemble(static, config)
    with torch.no_grad():
        blocks, _ = assemble(params, states, dt_worlds(states))
    sol = lcp_solve_full(*(blocks[k] for k in ("Q", "p", "G", "h", "A", "b",
                                               "F")),
                         q_is_diag=True, gamma_rows=static.c_max,
                         row_mask=blocks["row_mask"],
                         max_iter=config.max_iter, tol=config.solver_eps,
                         fric_pair=True)
    return blocks, sol


def bwd_kw(static, config):
    """``_lcp_bwd_impl``'s keywords as the step's solve passes them."""
    return dict(diag_q=True, gamma_rows=static.c_max, fric_pair=True,
                backend=config.lcp_backend,
                factor_precision=config.solver_factor_precision,
                refine=config.solver_refine)


def lcp_bwd(blocks, sol, g, kw):
    """The LCP's backward: cotangents (dQ, dp, dG, dh, dA, db, dF.mu)."""
    return _lcp_bwd_impl(sol.z, sol.s, sol.lam, sol.nu, blocks["Q"],
                         blocks["G"], blocks["A"], blocks["F"], g, **kw)


def bwd_factor_solves(blocks, sol, g, kw, k):
    """The backward's factor and ``k`` (1 or 2) trans=1 solves of
    [g; 0; 0], the second on the first's result (the JAX tool's
    ``bwd_factor_solve1`` / ``2``): w."""
    consts = pdipm._dtype_consts(sol.z.dtype)
    d_inv = torch.clamp(sol.s / torch.clamp(sol.lam, min=consts["tiny"]),
                        consts["dinv_min"], consts["dinv_max"])
    rhs = torch.cat([g, torch.zeros_like(sol.s), torch.zeros_like(sol.nu)],
                    -1)
    Q = blocks["Q"]
    solve = pdipm.make_kkt_factor(
        Q, Q, blocks["G"], blocks["A"], blocks["F"], consts["reg"],
        kw["backend"], kw["gamma_rows"], kw["refine"],
        kw["factor_precision"], kw["fric_pair"])(d_inv)
    w = solve(rhs, trans=1)
    return w if k == 1 else solve(rhs + 0.1 * w, trans=1)


def outers(w, sol, F):
    """The cotangent products of ``_lcp_bwd_impl`` given its solve's w:
    (dQ, dp, dG, dh, dA, db, dF.mu) for a diagonal Q and a ``ConeF``."""
    z, lam, nu = sol.z, sol.lam, sol.nu
    n, m = z.shape[-1], lam.shape[-1]
    wz, wl, wn = w[:, :n], w[:, n:n + m], w[:, n + m:]
    return (-(wz * z), -wz, -(bger(wl, z) + bger(lam, wz)), wl,
            -(bger(wn, z) + bger(nu, wz)), wn, wl[:, m - F.C:] * lam[:, :F.C])


def fwd_bwd_rollout(step, params, states, n_steps, remat):
    """mean(p^2) after ``core.rollout`` of ``n_steps`` and its gradient
    with respect to params.mass."""
    mass = params.mass.detach().requires_grad_(True)
    final, _ = rollout(step, dataclasses.replace(params, mass=mass), states,
                       bench.DT, n_steps, remat=remat)
    loss = (final.p ** 2).mean()
    (g,) = torch.autograd.grad(loss, mass)
    return loss.detach(), g


def rollout_parts(step, params, states, n_steps=N_STEPS):
    """The whole-rollout parts, label -> fn: fwd, fwd+bwd, rollout (fwd+bwd,
    remat=False), remat (remat=True)."""
    def fwd():
        with torch.no_grad():
            return (bench._steps(step, params, states, n_steps).p ** 2).mean()
    return {"fwd": fwd,
            "fwd+bwd": lambda: bench._fwd_bwd(step, params, states, n_steps),
            "rollout": lambda: fwd_bwd_rollout(step, params, states, n_steps,
                                               False),
            "remat": lambda: fwd_bwd_rollout(step, params, states, n_steps,
                                             True)}


def asm_outputs(assemble, params, states, dt_w):
    """The assembly's differentiable outputs: Q, p, G, h, F.mu."""
    bl, _ = assemble(params, states, dt_w)
    return bl["Q"], bl["p"], bl["G"], bl["h"], bl["F"].mu


def step_parts(static, config, step, params, states):
    """The one-step parts, label -> fn: step, step-vjp, lcp-bwd, bwd
    factor+1 solve, bwd factor+2 solves, outers, asm, asm-vjp.  The
    pullbacks' forwards run here, once."""
    pr, st, leaves = with_leaves(params, states)
    s1, _ = step(pr, st, bench.DT)
    step_vjp = pullback((s1.p, s1.v), leaves)
    blocks, sol = first_step_lcp(static, config, params, states)
    g = torch.ones_like(sol.z)
    kw = bwd_kw(static, config)
    with torch.no_grad():
        w = bwd_factor_solves(blocks, sol, g, kw, 1)
    assemble, _ = make_assemble(static, config)
    dt_w = dt_worlds(states)
    asm_vjp = pullback(asm_outputs(assemble, pr, st, dt_w), leaves)

    def nograd(f):
        def run():
            with torch.no_grad():
                return f()
        return run
    return {
        "step": nograd(lambda: step(params, states, bench.DT)[0]),
        "step-vjp": step_vjp,
        "lcp-bwd": nograd(lambda: lcp_bwd(blocks, sol, g, kw)),
        "bwd factor+1 solve": nograd(
            lambda: bwd_factor_solves(blocks, sol, g, kw, 1)),
        "bwd factor+2 solves": nograd(
            lambda: bwd_factor_solves(blocks, sol, g, kw, 2)),
        "outers": nograd(lambda: outers(w, sol, blocks["F"])),
        "asm": nograd(lambda: asm_outputs(assemble, params, states, dt_w)),
        "asm-vjp": asm_vjp}


def _combine(*terms):
    """The sum of coef * part over the (coef, part) terms as (host, event)
    ms; a part is a timing dict or a (host, event) pair."""
    pairs = [(c, (t["host_ms"], t["event_ms"]) if isinstance(t, dict)
              else t) for c, t in terms]
    host = sum(c * h for c, (h, _) in pairs)
    event = (None if any(e is None for _, (_, e) in pairs)
             else sum(c * e for c, (_, e) in pairs))
    return host, event


def components(static, config, params, states, device="cuda",
               n_steps=N_STEPS, calls=(1, 5), windows=bench.WINDOWS):
    """Each part's timing dict (``tools.bench.time_turns``, its warm-up
    output under "out"), the rollout parts at ``calls[0]`` calls a window
    and the one-step parts at ``calls[1]``, each group in turns; then the
    derived (host, event) ms: ``bwd (rollout)`` (fwd+bwd - fwd), ``bwd
    solve (x1)`` and ``bwd factor`` (the marginal), ``known per step``
    (lcp-bwd + asm-vjp), ``measured per step`` (the rollout's bwd / steps)
    and ``unexplained per step``."""
    step = make_batched_step(static, config)
    out = bench.time_turns(rollout_parts(step, params, states, n_steps),
                           device, calls[0], windows, steps=n_steps)
    out.update(bench.time_turns(
        step_parts(static, config, step, params, states), device, calls[1],
        windows))
    out["bwd (rollout)"] = _combine((1, out["fwd+bwd"]), (-1, out["fwd"]))
    out["bwd solve (x1)"], out["bwd factor"] = _marginal(
        out["bwd factor+1 solve"], out["bwd factor+2 solves"])
    out["known per step"] = _combine((1, out["lcp-bwd"]),
                                     (1, out["asm-vjp"]))
    out["measured per step"] = _combine((1 / n_steps, out["bwd (rollout)"]))
    out["unexplained per step"] = _combine((1, out["measured per step"]),
                                           (-1, out["known per step"]))
    return out


def _ms(pair):
    host, event = pair
    ev = "not measured" if event is None else f"{event:8.3f}"
    return f"{host:9.3f} {ev:>12s}"


# (label in the table, key of ``components``), in the JAX tool's order
TABLE = [("rollout fwd (8 steps)", "fwd"),
         ("rollout fwd+bwd (bench._fwd_bwd)", "fwd+bwd"),
         ("rollout fwd+bwd, remat=False", "rollout"),
         ("rollout fwd+bwd, remat=True", "remat"),
         ("one step fwd", "step"),
         ("one step vjp pullback", "step-vjp"),
         ("lcp bwd (_lcp_bwd_impl, total)", "lcp-bwd"),
         ("  bwd factor (+ P-plane)", "bwd factor"),
         ("  bwd transposed solve (x1)", "bwd solve (x1)"),
         ("  cotangent outers (dQ/dp/dG/dh/dA/dF)", "outers"),
         ("assembly fwd (reference)", "asm"),
         ("assembly VJP pullback", "asm-vjp"),
         ("known per-step bwd (lcp_bwd + asm_vjp)", "known per step"),
         ("measured per-step bwd (rollout)", "measured per step"),
         ("measured per-step bwd (1-step vjp)", "step-vjp"),
         ("unexplained per step", "unexplained per step")]


def lines(comp, n_steps=N_STEPS):
    """The report's lines: the JAX tool's two summary lines, then its
    table with host ms, event ms and launches a call."""
    fwd, fb, bwd = comp["fwd"], comp["fwd+bwd"], comp["bwd (rollout)"]
    out = [f"[bwd_roofline] rollout fwd {fwd['host_ms']:.1f} ms, fwd+bwd "
           f"{fb['host_ms']:.1f} ms -> bwd {bwd[0]:.1f} ms "
           f"({bwd[0] / fwd['host_ms']:.2f}x fwd; {bwd[0] / n_steps:.2f} "
           f"ms/step)",
           f"[bwd_roofline] one step: fwd {comp['step']['host_ms']:.2f} ms, "
           f"vjp pullback {comp['step-vjp']['host_ms']:.2f} ms "
           f"(x{n_steps} steps = {comp['step-vjp']['host_ms'] * n_steps:.1f}"
           f" ms)",
           f"[bwd_roofline] {'component':42s} {'host ms':>9s} "
           f"{'event ms':>12s}  launches a call"]
    for label, key in TABLE:
        t = comp[key]
        if isinstance(t, dict):
            pair, launches = (t["host_ms"], t["event_ms"]), t["launches"]
        else:
            pair, launches = t, "-"
        out.append(f"[bwd_roofline] {label:42s} {_ms(pair)}  {launches}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu is for tests; the default is the card")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bwd_roofline: no CUDA device")
    bench.log(f"[bwd_roofline] {bench.device_line(args.device)}")
    static, params, states, config = dense_scene(device=args.device)
    bench.log(f"[bwd_roofline] dense scene: B={states.p.shape[0]}, "
              f"{static.n_bodies} bodies, c_max={static.c_max}, {N_STEPS} "
              f"steps, {states.p.dtype}")
    for line in lines(components(static, config, params, states,
                                 args.device)):
        bench.log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
