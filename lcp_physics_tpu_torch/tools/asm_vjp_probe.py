"""The assembly's pullback taken apart stage by stage (counterpart of the
repository's ``tools/asm_vjp_probe.py``).

On the bench's dense 64-circle grid (``tools.bench.build_world_scene(
dense=True)``, B = 256, c_max = 128, float32, dt 0.01), the forward and
the pullback (ones cotangents, ``torch.autograd.grad(retain_graph=True)``
after one forward) of:

  full       the whole assembly: Q, p, G, h, F.mu (the anchor; it should
             match ``bwd_roofline``'s asm-vjp)
  eq         ``assemble.eq``: mass, forces, Je
  contacts   ``assemble.contacts``: the narrowphase and the compaction
  blocks     ``assemble.contact_blocks`` (Jc/Jf, G, h, F) with the contact
             buffer's indices held fixed
  pairs      ``core.geometry.circle_circle`` over the 2016 static pairs of
             ``SceneStatic.pair_lists()`` (the gathers pos[i], radius[i];
             their pullback is a scatter-add (B, P, 2) -> (B, N, 2))
  compact    ``take_along_dim`` (B, P, 7) -> (B, C, 7) at the JAX tool's
             ``default_rng(0)`` permutations (pullback: one scatter-add)
  dyn-take   ``restitution[contacts.ia]`` through ``core.step._take``
             (pullback: a scatter-add (B, C) -> (N,))

each timed by the bench's window timer (``tools.bench.time_turns``: host
clock, CUDA events beside it), all in turns.  The JAX tool could only
suspect that scatters were what it measured; here each pullback runs once
more under ``torch.profiler`` (``utils.observe.activities()``) and the
three device kernels that take the most of its time are named ("not
measured" where the profiler's pass comes back without device events,
as it has once in a while for a short pullback late in a long process).

Usage: ``python -m lcp_physics_tpu_torch.tools.asm_vjp_probe [--device
cuda|cpu]``.  The default is the card; without one it raises.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from lcp_physics_tpu_torch.core import make_assemble
from lcp_physics_tpu_torch.core.geometry import Contacts, circle_circle
from lcp_physics_tpu_torch.core.step import _take
from lcp_physics_tpu_torch.tools import bench
from lcp_physics_tpu_torch.tools.bwd_roofline import (asm_outputs,
                                                      dense_scene,
                                                      dt_worlds, leaf,
                                                      pullback, with_leaves)
from lcp_physics_tpu_torch.utils import observe

TOP = 3   # device kernels named for each pullback


def stages(static, config, params, states):
    """label -> (forward fn, the leaves its pullback reaches), in the JAX
    tool's order; each fn returns the stage's outputs as a tuple."""
    assemble, _ = make_assemble(static, config)
    dt_w = dt_worlds(states)
    pr, st, leaves = with_leaves(params, states)
    with torch.no_grad():
        contacts, rmask = assemble.contacts(params, states, dt_w)
        eq = assemble.eq(params, states, dt_w)
    out = {"full": (lambda: asm_outputs(assemble, pr, st, dt_w), leaves),
           "eq": (lambda: tuple(assemble.eq(pr, st, dt_w).values()), leaves),
           "contacts": (lambda: tuple(assemble.contacts(pr, st, dt_w)[0])[:4],
                        leaves)}

    buf = [leaf(x) for x in contacts[:4]]      # normal, ra, rb, depth

    def blocks():
        c = Contacts(*buf, contacts.ia, contacts.ib, contacts.valid)
        bl = assemble.contact_blocks(pr, st, c, eq, rmask, dt_w)
        return bl["G"], bl["h"], bl["F"].mu
    out["blocks"] = (blocks, leaves + buf)

    ci, cj = (torch.as_tensor(np.asarray(i), device=states.p.device)
              for i in static.pair_lists()["cc"])
    pos, rad = leaf(states.p[:, :, 1:3]), leaf(params.radius)
    out["pairs"] = (lambda: circle_circle(pos[:, ci], rad[ci], pos[:, cj],
                                          rad[cj]), [pos, rad])

    B, P, C = states.p.shape[0], ci.shape[0], static.c_max
    rng = np.random.default_rng(0)
    keep = torch.as_tensor(np.stack([rng.permutation(P)[:C]
                                     for _ in range(B)]),
                           device=states.p.device)
    packed = leaf(torch.as_tensor(rng.normal(size=(B, P, 7)),
                                  dtype=states.p.dtype,
                                  device=states.p.device))
    out["compact"] = (lambda: (torch.take_along_dim(packed, keep[..., None],
                                                    dim=1),), [packed])
    rest = leaf(params.restitution)
    out["dyn-take"] = (lambda: (_take(rest, contacts.ia),), [rest])
    return out


def top_kernels(fn, device, top=TOP):
    """The ``top`` device kernels of one fn() call by device time under
    ``torch.profiler``: [(name, ms)], or None off the card or where the
    profiler's pass comes back without device events."""
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=observe.activities()) as prof:
        fn()
        torch.cuda.synchronize(device)
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    ev.sort(key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3) for e in ev[:top]] or None


def components(static, config, params, states, device="cuda", calls=5,
               windows=bench.WINDOWS):
    """label -> {"fwd": timing, "pull": timing, "top": ``top_kernels`` of
    one pullback}, every forward (without grad) and pullback timed in
    turns by ``tools.bench.time_turns`` (each timing keeps its warm-up
    output under "out")."""
    parts = stages(static, config, params, states)
    fns = {}
    for label, (f, leaves) in parts.items():
        def fwd(f=f):
            with torch.no_grad():
                return f()
        fns[(label, "fwd")] = fwd
        fns[(label, "pull")] = pullback(f(), leaves)
    t = bench.time_turns(fns, device, calls, windows)
    return {label: dict(fwd=t[(label, "fwd")], pull=t[(label, "pull")],
                        top=top_kernels(fns[(label, "pull")], device))
            for label in parts}


def _ms(t):
    ev = ("not measured" if t["event_ms"] is None
          else f"{t['event_ms']:.3f}")
    return f"{t['host_ms']:7.3f} (events {ev})"


def lines(comp):
    """The JAX tool's line for each stage (fwd and pull ms), with the
    pullback's top device kernels under it."""
    out = []
    for label, r in comp.items():
        out.append(f"[asm_vjp] {label:10s} fwd {_ms(r['fwd'])}  pull "
                   f"{_ms(r['pull'])} ms")
        if r["top"] is None:
            out.append("[asm_vjp]   top device kernels: not measured")
        for name, ms in r["top"] or ():
            out.append(f"[asm_vjp]   {ms:8.3f} ms  {name[:90]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu is for tests; the default is the card")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("asm_vjp_probe: no CUDA device")
    bench.log(f"[asm_vjp] {bench.device_line(args.device)}")
    static, params, states, config = dense_scene(device=args.device)
    P = len(static.pair_lists()["cc"][0])
    bench.log(f"[asm_vjp] dense scene: B={states.p.shape[0]}, "
              f"{static.n_bodies} bodies, {P} circle pairs, "
              f"c_max={static.c_max}, {states.p.dtype}")
    for line in lines(components(static, config, params, states,
                                 args.device)):
        bench.log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
