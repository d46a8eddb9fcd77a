"""Parameter inference demo: recover a body's mass and restitution by
gradient descent through the differentiable contact rollout (the JAX
package's ``demos/inference.py`` through the port).

The scene lowers once to the functional core; each epoch is one rollout of
``core.make_step`` and its backward.  ``--batch B`` optimizes B random
initial guesses at once as B worlds of one batched step with per-world
parameters.

Run: python -m lcp_physics_tpu_torch.demos.inference [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from lcp_physics_tpu_torch.core import make_step, make_step_batched, rollout
from lcp_physics_tpu_torch.parallel import tile_state
from lcp_physics_tpu_torch.physics import (Circle, ExternalForce, Rect,
                                           TotalConstraint, World)
from lcp_physics_tpu_torch.utils import SimConfig

G = 100.0
DT = 1.0 / 60.0
STEPS = 120


def side_force(t):
    """A constant unit +x force at every time of t."""
    t = torch.as_tensor(t, dtype=torch.float64) \
        if not isinstance(t, torch.Tensor) else t
    return torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype,
                        device=t.device).expand(t.shape + (3,))


def build_scene(dtype=torch.float32, device="cuda"):
    """(static, params, state) of a ball pushed sideways over a floor."""
    ball = Circle([300.0, 100.0], 20.0, mass=2.0, restitution=0.65,
                  fric_coeff=0.3)
    # A constant known-magnitude side force makes mass identifiable
    # (acceleration = F/m); gravity alone would not, since a = g for any m.
    ball.add_force(ExternalForce(side_force, multiplier=150.0))
    floor = Rect([400.0, 300.0], [700.0, 40.0], mass=100.0,
                 restitution=0.9, fric_coeff=0.3)
    world = World([ball, floor], [TotalConstraint(floor)], dt=DT,
                  gravity=(0.0, G), dtype=dtype, device=device)
    return world.functional()


def with_guess(params, mass, restitution):
    """params with body 0's mass and restitution replaced (per world when
    the guesses carry a batch axis)."""
    def put(x, v):
        return torch.cat([v[..., None], x[..., 1:]], dim=-1)
    return dataclasses.replace(params, mass=put(params.mass, mass),
                               restitution=put(params.restitution,
                                               restitution))


def trajectory(step, params, state0, n=STEPS):
    """The ball's pose (n, 3) over an n-step rollout ((n, B, 3) batched)."""
    _, traj = rollout(step, params, state0, DT, n)
    return traj.p[..., 0, :]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=0,
                    help="optimize this many random initial guesses at "
                         "once, as a batch of worlds")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dtype = torch.float32
    static, true_params, state0 = build_scene(dtype, args.device)
    opts = dict(dtype=dtype, device=args.device)
    if args.batch:
        B = args.batch
        rng = np.random.default_rng(0)
        step = make_step_batched(static, SimConfig(), params_batched=True)
        state0 = tile_state(state0, B)
        true_params = dataclasses.replace(true_params, **{
            f: getattr(true_params, f).expand(
                (B,) + getattr(true_params, f).shape).clone()
            for f in ("mass", "inertia", "restitution", "fric_coeff",
                      "radius", "verts", "gravity")})
        mass = torch.tensor(rng.uniform(0.3, 5.0, B), **opts)
        rest = torch.tensor(rng.uniform(0.05, 0.9, B), **opts)
        reduce = lambda e: e.mean(dim=(0, 2))      # per world
    else:
        step = make_step(static, SimConfig())
        mass = torch.tensor(1.0, **opts)
        rest = torch.tensor(0.3, **opts)
        reduce = lambda e: e.mean()
    with torch.no_grad():
        target = trajectory(step, true_params, state0)
    mass.requires_grad_(True)
    rest.requires_grad_(True)
    opt = torch.optim.Adam([mass, rest], lr=args.lr)

    t0 = time.time()
    for epoch in range(args.epochs):
        params = with_guess(true_params, mass, rest)
        loss = reduce((trajectory(step, params, state0) - target) ** 2)
        opt.zero_grad()
        loss.sum().backward()
        opt.step()
        with torch.no_grad():
            rest.clamp_(0.0, 0.95)
            mass.clamp_(0.1, 10.0)
        if epoch % 25 == 0 or epoch == args.epochs - 1:
            k = int(loss.argmin()) if args.batch else ...
            lv, m, r = (float(x.detach()[k]) for x in (loss, mass, rest))
            print(f"epoch {epoch:4d} loss {lv:.6f} mass {m:.4f} (true 2.0) "
                  f"restitution {r:.4f} (true 0.65)", flush=True)
    print(f"optimized {args.epochs} epochs x {STEPS} steps in "
          f"{time.time() - t0:.1f}s")
    good = (mass - 2.0).abs().lt(0.15) & (rest - 0.65).abs().lt(0.05)
    ok = bool(good.any())
    if args.batch:
        print(f"{int(good.sum())}/{args.batch} starts converged")
    print("converged:", ok)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
