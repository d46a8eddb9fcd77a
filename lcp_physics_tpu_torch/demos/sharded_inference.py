"""Parameter inference over a world batch sharded across a device mesh
(the JAX package's ``demos/sharded_inference.py`` through the port).

Domain-randomized gradient descent: each of the worlds drops the ball from
a slightly different pose and velocity, the batch is sharded over the
mesh (``parallel.batched_rollout(mesh=...)``, one worker thread per mesh
entry), the ball's mass is one shared parameter replicated to every
shard, and its gradient is the sum of the shards' contributions.  On one
card the mesh has one entry; ``--shards k`` lists the cards k times
between them, ``--device cpu`` runs on the CPU.

Run: python -m lcp_physics_tpu_torch.demos.sharded_inference
     [--worlds 256 --epochs 60 --lr 0.1] [--device cpu] [--shards k]
"""
import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from lcp_physics_tpu_torch.core import WorldState
from lcp_physics_tpu_torch.demos.inference import side_force
from lcp_physics_tpu_torch.parallel import (batched_rollout, gather,
                                            make_mesh, tile_state)
from lcp_physics_tpu_torch.physics import (Circle, ExternalForce, Rect,
                                           TotalConstraint, World)
from lcp_physics_tpu_torch.utils import SimConfig

G = 100.0
DT = 1.0 / 60.0
STEPS = 60
TRUE_MASS = 2.0


def build_scene(dtype=torch.float32, device="cuda"):
    """(static, params, state) of the ball pushed sideways over a floor."""
    ball = Circle([300.0, 100.0], 20.0, mass=TRUE_MASS, restitution=0.65,
                  fric_coeff=0.3)
    # A known side force makes mass identifiable (a = F/m).
    ball.add_force(ExternalForce(side_force, multiplier=150.0))
    floor = Rect([400.0, 300.0], [700.0, 40.0], mass=100.0,
                 restitution=0.9, fric_coeff=0.3)
    world = World([ball, floor], [TotalConstraint(floor)], dt=DT,
                  gravity=(0.0, G), dtype=dtype, device=device)
    return world.functional()


def randomized_states(state0, batch, seed=0):
    """Domain randomization, with the JAX demo's numpy draws: each world
    drops the ball from a slightly different pose and velocity."""
    rng = np.random.default_rng(seed)
    states = tile_state(state0, batch)
    dp = np.zeros((batch,) + tuple(state0.p.shape), np.float64)
    dp[:, 0, 1] = rng.uniform(-40.0, 40.0, batch)       # ball x
    dp[:, 0, 2] = rng.uniform(-30.0, 0.0, batch)        # ball y (higher)
    dv = np.zeros((batch,) + tuple(state0.v.shape), np.float64)
    dv[:, 0, 1:3] = rng.normal(0.0, 20.0, (batch, 2))   # ball velocity
    as_t = lambda x: torch.as_tensor(x, dtype=states.p.dtype,
                                     device=states.p.device)
    return WorldState(p=states.p + as_t(dp), v=states.v + as_t(dv),
                      t=states.t)


def ball_track(outs, device):
    """The ball's (x, y) over every step and world, (steps, B, 2) on
    ``device``, from the per-shard results of a sharded rollout."""
    return gather([traj.p[:, :, 0, 1:3] for _, traj in outs], device, dim=1)


def loss_and_grad(log_mass, static, params, states, target, mesh,
                  config=SimConfig()):
    """The demo's loss at ball mass exp(log_mass) and its gradient with
    respect to log_mass: the mean squared error of the ball's position
    over every step and world against ``target`` (steps, B, 2).  The
    worlds roll out sharded over ``mesh``; the tracks are gathered to the
    mesh's first device."""
    log_mass = log_mass.detach().requires_grad_(True)
    mass = torch.cat([torch.exp(log_mass)[None], params.mass[1:]])
    outs = batched_rollout(static, config,
                           dataclasses.replace(params, mass=mass), states,
                           DT, target.shape[0], mesh=mesh)
    loss = ((ball_track(outs, mesh.devices[0]) - target) ** 2).mean()
    (grad,) = torch.autograd.grad(loss, log_mass)
    return loss.detach(), grad


def demo_mesh(device="cuda", shards=None):
    """The demo's mesh: every visible card (``shards`` entries cycling
    over them when given), or ``shards`` CPU entries (default 1)."""
    if device == "cpu":
        return make_mesh([torch.device("cpu")] * (shards or 1))
    mesh = make_mesh()
    if shards is None:
        return mesh
    return make_mesh([mesh.devices[i % mesh.size] for i in range(shards)])


def fit(static, true_params, states, mesh, epochs, lr=0.1,
        config=SimConfig()):
    """Recover the ball's mass from the worlds' ground-truth tracks: Adam
    on log(mass) from 0.6 of the true mass.  Returns per epoch (loss,
    d loss / d log(mass), mass after the step)."""
    dev = mesh.devices[0]
    with torch.no_grad():
        target = ball_track(batched_rollout(static, config, true_params,
                                            states, DT, STEPS, mesh=mesh),
                            dev)
    log_mass = torch.tensor(math.log(0.6 * TRUE_MASS),
                            dtype=states.p.dtype, device=dev,
                            requires_grad=True)
    opt = torch.optim.Adam([log_mass], lr=lr)
    history = []
    for epoch in range(epochs):
        val, log_mass.grad = loss_and_grad(log_mass, static, true_params,
                                           states, target, mesh, config)
        opt.step()
        history.append((float(val), float(log_mass.grad),
                        float(torch.exp(log_mass.detach()))))
        if epoch % 10 == 0 or epoch == epochs - 1:
            print(f"epoch {epoch:3d}: loss {history[-1][0]:.5f} "
                  f"mass {history[-1][2]:.4f} (true {TRUE_MASS})",
                  flush=True)
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh entries (default: one per visible card; "
                         "on the CPU 1)")
    args = ap.parse_args(argv)

    mesh = demo_mesh(args.device, args.shards)
    n = mesh.size
    B = (args.worlds // n) * n or n
    print(f"mesh: {n} entries {[str(d) for d in mesh.devices]}, {B} worlds "
          f"({B // n}/entry)", flush=True)
    static, true_params, state0 = build_scene(torch.float32, mesh.devices[0])
    t0 = time.perf_counter()
    history = fit(static, true_params, randomized_states(state0, B), mesh,
                  args.epochs, args.lr)
    print(f"{args.epochs} epochs of {STEPS} steps fwd+bwd: "
          f"{1e3 * (time.perf_counter() - t0) / args.epochs:.1f} ms per "
          f"epoch (with the ground-truth rollout)", flush=True)
    return history[-1][2]


if __name__ == "__main__":
    main()
