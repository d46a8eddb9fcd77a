"""Billiards control demo: optimize the cue ball's initial velocity so that
the target ball ends up in the goal, differentiating through the full
contact-rich trajectory (the JAX package's ``demos/billiards.py`` through
the port).

Run: python -m lcp_physics_tpu_torch.demos.billiards [--device cpu]
"""
import argparse
import time

import torch

from lcp_physics_tpu_torch.core import WorldState, make_step, rollout
from lcp_physics_tpu_torch.physics import (Circle, Rect, TotalConstraint,
                                           World)
from lcp_physics_tpu_torch.utils import SimConfig

DT = 1.0 / 60.0
STEPS = 150
GOAL = (600.0, 200.0)


def build_scene(dtype=torch.float32, device="cuda"):
    """(static, params, state) of a cue ball, a target ball and four rails."""
    cue = Circle([200.0, 250.0], 15.0, restitution=0.9, fric_coeff=0.1)
    target = Circle([400.0, 250.0], 15.0, restitution=0.9, fric_coeff=0.1)
    rails, cons = [], []
    for pos, dims in [((400, 40), (650, 30)), ((400, 460), (650, 30)),
                      ((60, 250), (30, 360)), ((740, 250), (30, 360))]:
        r = Rect(list(pos), list(dims), mass=100.0, restitution=0.9)
        rails.append(r)
        cons.append(TotalConstraint(r))
    world = World([cue, target] + rails, cons, dt=DT, gravity=(0.0, 0.0),
                  dtype=dtype, device=device)
    return world.functional()


def final_target_pos(step, params, state0, cue_v, n=STEPS):
    """The target ball's position after ``n`` steps with the cue ball
    started at velocity ``cue_v`` (2,)."""
    v = torch.cat([torch.cat([state0.v[0, :1], cue_v])[None], state0.v[1:]])
    final, _ = rollout(step, params, WorldState(state0.p, v, state0.t), DT, n)
    return final.p[1, 1:3]


def loss_fn(step, params, state0, cue_v, n=STEPS):
    goal = torch.tensor(GOAL, dtype=state0.p.dtype, device=state0.p.device)
    return ((final_target_pos(step, params, state0, cue_v, n) - goal)
            ** 2).sum()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--lr", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    static, params, state0 = build_scene(device=args.device)
    step = make_step(static, SimConfig())
    # initial guess: roughly toward the target
    cue_v = torch.tensor([120.0, 10.0], dtype=state0.p.dtype,
                         device=state0.p.device, requires_grad=True)
    opt = torch.optim.Adam([cue_v], lr=args.lr)

    t0 = time.time()
    for epoch in range(args.epochs):
        loss = loss_fn(step, params, state0, cue_v)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if epoch % 20 == 0 or epoch == args.epochs - 1:
            vx, vy = cue_v.detach().tolist()
            print(f"epoch {epoch:4d} dist^2 {float(loss.detach()):9.2f} "
                  f"cue_v=({vx:7.2f}, {vy:7.2f})", flush=True)
    with torch.no_grad():
        final = final_target_pos(step, params, state0, cue_v)
    goal = torch.tensor(GOAL, dtype=final.dtype, device=final.device)
    dist = float(torch.linalg.vector_norm(final - goal))
    fx, fy = final.tolist()
    print(f"final target-ball position ({fx:.1f}, {fy:.1f}), goal "
          f"({GOAL[0]:.0f}, {GOAL[1]:.0f}), miss distance {dist:.2f} "
          f"({time.time() - t0:.1f}s)")
    print("converged:", dist < 20.0)
    return 0 if dist < 20.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
