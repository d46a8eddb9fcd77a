"""Parameter inference on circle worlds: the rollout loss, its gradient
with respect to per-body mass and restitution, and Adam's steps.

Each world scores its own guesses: the mean over steps, bodies and the
three coordinates of the squared gap between the positions rolled out
under the guesses and under the true parameters.  The objective is the
sum of the worlds' losses, so a world's gradient is its own.  An Adam
step (betas 0.9 and 0.999, eps 1e-8) is followed by the clamps of the
inference demo: mass to [0.1, 10], restitution to [0, 0.95].
"""
from __future__ import annotations

import torch

from benchmark.reference import world as W

BETAS = (0.9, 0.999)
EPS = 1e-8
CLAMPS = {"mass": (0.1, 10.0), "restitution": (0.0, 0.95)}
LEAVES = ("mass", "restitution")


def losses(world, guess, p0, v0, dt, n_steps, solver, target):
    """Per-world losses (B,) of the guesses (a dict of (B, N) tensors)."""
    traj = W.rollout(dict(world, **guess), p0, v0, dt, n_steps, solver)
    return ((traj - target) ** 2).mean(dim=(0, 2, 3))


def adam(world, guess, p0, v0, dt, n_steps, solver, target, lr, steps):
    """``steps`` Adam steps from ``guess``.  Returns (per-world losses of
    each step, the first step's gradients, the guesses after the last
    step), the gradients and guesses as dicts over ``LEAVES``."""
    x = {k: guess[k].detach().clone() for k in LEAVES}
    m = {k: torch.zeros_like(x[k]) for k in LEAVES}
    v = {k: torch.zeros_like(x[k]) for k in LEAVES}
    out_losses, first = [], None
    for t in range(1, steps + 1):
        leaves = {k: x[k].clone().requires_grad_(True) for k in LEAVES}
        loss = losses(world, leaves, p0, v0, dt, n_steps, solver, target)
        grads = torch.autograd.grad(loss.sum(), [leaves[k] for k in LEAVES])
        g = dict(zip(LEAVES, grads))
        out_losses.append(loss.detach())
        if first is None:
            first = g
        for k in LEAVES:
            m[k] = BETAS[0] * m[k] + (1 - BETAS[0]) * g[k]
            v[k] = BETAS[1] * v[k] + (1 - BETAS[1]) * g[k] ** 2
            mhat = m[k] / (1 - BETAS[0] ** t)
            vhat = v[k] / (1 - BETAS[1] ** t)
            x[k] = torch.clamp(x[k] - lr * mhat / (vhat.sqrt() + EPS),
                               *CLAMPS[k])
    return out_losses, first, x
