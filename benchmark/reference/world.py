"""Worlds of rigid bodies: the contact LCP's blocks and one step.

A batch of worlds holds N bodies each, of the shape that the world's
``shape`` names; its narrowphase (``reference/shapes/<shape>.py``) gives
the contacts and, where the module defines ``equality(world, p)``, the
equality rows A v = b of the world's joints (``reference/joints.py``).
A world holds positions p (B, N, 3) = [angle, x, y], velocities v
(B, N, 3) = [omega, vx, vy] and per-body mass, inertia, restitution and
friction ((N,) shared or (B, N) per world).
The contact model is the engine's (Stewart-Trinkle / Anitescu-Potra at
the velocity level):

* the shape's narrowphase gives at most ``c_max`` contacts a world;
* G = [-Jc; -Jf; 0] over rows [normal (C); +t, -t (2C); gamma (C)], the
  friction cone F = [[0, 0, 0], [0, 0, -E], [-diag(mu), E', 0]], mu the
  geometric mean of the two friction coefficients;
* h on a normal row: restitution e (Jc v) with e the mean of the two
  bodies' restitution, where the contact touches or would close its gap
  this step, else gap / dt; padded rows get zero rows, h = 1 and mask 0;
* the equality rows, where the shape has any, go to the LCP as A and b;
* the LCP's z is the new velocity and p' = p + dt z.

A batch here is any set of worlds: each world's rows depend on that world
alone, so the reference takes a sample of the program's worlds.
"""
from __future__ import annotations

import importlib

import torch

from benchmark.reference import lcp

FRIC_DIRS = 2


def as_batch(x, B):
    """A per-body parameter (N,) or (B, N) as (B, N)."""
    return x.expand(B, -1) if x.dim() == 1 else x


def shape(name):
    """The reference's module of body shape ``name``
    (``reference/shapes/<name>.py``)."""
    return importlib.import_module(f"benchmark.reference.shapes.{name}")


def params(config, dtype, device):
    """The ``world`` dict of a configuration, by its ``shape``."""
    return shape(config["shape"]).params(config, dtype, device)


def _rows(direction, ra, rb, ia, ib, mask, N):
    """Jacobian rows (B, C, 3N) of the separation rate along
    ``direction`` (B, C, 2) at contacts with offsets ra, rb."""
    dx, dy = direction[..., 0], direction[..., 1]
    cross = lambda r: r[..., 0] * dy - r[..., 1] * dx
    blk_a = torch.stack([cross(ra), dx, dy], -1)
    blk_b = -torch.stack([cross(rb), dx, dy], -1)
    oh_a = torch.nn.functional.one_hot(ia, N).to(ra.dtype)
    oh_b = torch.nn.functional.one_hot(ib, N).to(ra.dtype)
    J = oh_a[..., :, None] * blk_a[..., None, :] \
        + oh_b[..., :, None] * blk_b[..., None, :]
    B, C = mask.shape
    return (mask[..., None, None] * J).reshape(B, C, 3 * N)


def cone(mu, valid):
    """The dense friction-cone block F (B, 4C, 4C)."""
    B, C = mu.shape
    m = (2 + FRIC_DIRS) * C
    F = mu.new_zeros((B, m, m))
    eye = torch.eye(C, dtype=mu.dtype, device=mu.device)
    vf = valid.repeat(1, FRIC_DIRS)
    Ev = torch.cat([eye] * FRIC_DIRS, 0) * vf[..., None] * valid[..., None, :]
    F[:, C:3 * C, 3 * C:] = -Ev
    F[:, 3 * C:, :C] = -mu[..., None] * eye
    F[:, 3 * C:, C:3 * C] = Ev.transpose(-1, -2)
    return F


def blocks(world, p, v, dt):
    """The contact LCP of one step of every world: a dict of Q (diagonal,
    (B, 3N)), p, G, h, F (dense), row_mask, the cone's mu and valid mask
    (B, C) and the number of valid contacts a world, and A (B, q, 3N) and
    b (B, q) where the shape module defines ``equality``.  ``world``
    holds its shape, mass, inertia, restitution, fric_coeff and the
    shape's own sizes ((N,) or (B, N)), gravity (2,) and c_max."""
    B, N = p.shape[:2]
    mass = as_batch(world["mass"], B)
    rest = as_batch(world["restitution"], B)
    fric = as_batch(world["fric_coeff"], B)
    inertia = as_batch(world["inertia"], B)
    g = world["gravity"]
    body = shape(world["shape"])
    normal, ra, rb, depth, ia, ib, valid = body.contacts(world, p, v, dt)
    mask = valid.to(p.dtype)
    Mdiag = torch.stack([inertia, mass, mass], -1).reshape(B, 3 * N)
    f = torch.zeros_like(p)
    f[..., 1:3] += mass[..., None] * g
    vf = v.reshape(B, -1)
    u = Mdiag * vf + dt * f.reshape(B, -1)
    Jc = _rows(normal, ra, rb, ia, ib, mask, N)
    t = torch.stack([-normal[..., 1], normal[..., 0]], -1)
    Jf = torch.cat([_rows(t, ra, rb, ia, ib, mask, N),
                    _rows(-t, ra, rb, ia, ib, mask, N)], 1)
    take = lambda x, idx: x.gather(-1, idx)
    e = 0.5 * (take(rest, ia) + take(rest, ib))
    mu = torch.sqrt(torch.clamp(take(fric, ia) * take(fric, ib),
                                min=0.0)) * mask
    jcv = (Jc @ vf[..., None])[..., 0]
    gap = torch.clamp(-depth, min=0.0)
    hit = ((-jcv) * dt >= gap) | (gap <= 0)
    h_n = torch.where(valid, torch.where(hit, e * jcv, gap / dt), 1.0)
    h_f = torch.where(valid.repeat(1, FRIC_DIRS), 0.0, 1.0).to(p.dtype)
    h_g = torch.where(valid, 0.0, 1.0).to(p.dtype)
    out = dict(Q=Mdiag, p=-u,
               G=torch.cat([-Jc, -Jf, torch.zeros_like(Jc)], 1),
               h=torch.cat([h_n, h_f, h_g], -1), F=cone(mu, mask),
               row_mask=torch.cat([mask, mask.repeat(1, FRIC_DIRS), mask],
                                  -1),
               mu=mu, valid=mask, n_contacts=valid.sum(-1))
    if hasattr(body, "equality"):
        out["A"], out["b"] = body.equality(world, p)
    return out


def step(world, p, v, dt, solver):
    """One step of every world: (p', v').  ``solver`` holds max_iter, tol,
    stall_lim and solver_dtype of the LCP solve."""
    B, N = p.shape[:2]
    blk = blocks(world, p, v, dt)
    z = lcp.lcp_solve(blk["Q"], blk["p"], blk["G"], blk["h"], blk["F"],
                      blk["row_mask"], A=blk.get("A"), b=blk.get("b"),
                      **solver)
    v_new = z.reshape(B, N, 3)
    return p + dt * v_new, v_new


def rollout(world, p, v, dt, n_steps, solver):
    """Positions (n_steps, B, N, 3) after each of ``n_steps`` steps."""
    traj = []
    for _ in range(n_steps):
        p, v = step(world, p, v, dt, solver)
        traj.append(p)
    return torch.stack(traj)
