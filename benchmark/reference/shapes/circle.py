"""Circles: every pair of circles is a candidate (or the pairs that the
world's ``pairs`` lists, as a jointed world's are); a pair is a contact
while its gap is under the sum of both bodies' speculative margins,
dt (|v| + |omega| r + dt |g|) + 10 tol, and their margin-inflated boxes
overlap; past ``c_max`` candidates the deepest ``c_max`` are kept."""
from __future__ import annotations

import numpy as np
import torch

TOL = 1e-6      # the engine's contact tolerance (speculative slop)


def params(config, dtype, device):
    """The configuration's per-body parameters (N,), its gravity and
    ``c_max``: the ``world`` dict of ``benchmark.reference.world``."""
    N = config["bodies"]
    full = lambda x: torch.full((N,), float(x), dtype=dtype, device=device)
    r = config["radius"]
    return dict(shape="circle", mass=full(config["mass"]),
                inertia=full(0.5 * config["mass"] * r * r),
                restitution=full(config["restitution"]),
                fric_coeff=full(config["fric_coeff"]), radius=full(r),
                gravity=torch.tensor(config["gravity"], dtype=dtype,
                                     device=device),
                c_max=config["c_max"])


def margins(v, radius, gravity, dt):
    """(B, N) speculative band of each circle (module docstring)."""
    speed = (torch.linalg.vector_norm(v[..., 1:3], dim=-1)
             + v[..., 0].abs() * radius)
    g = torch.linalg.vector_norm(gravity, dim=-1)
    return (dt * (speed + dt * g) + 10.0 * TOL).detach()


def contacts(world, p, v, dt):
    """The padded contact buffer (normal, ra, rb, depth, ia, ib, valid) of
    the circle worlds, each (B, c_max, ...); ``normal`` points from body
    b to body a, ``depth`` > 0 overlapping."""
    B, N = p.shape[:2]
    radius = world["radius"]
    radius = radius.expand(B, -1) if radius.dim() == 1 else radius
    margin = margins(v, radius, world["gravity"], dt)
    c_max = world["c_max"]
    iu, ju = world["pairs"] if "pairs" in world else np.triu_indices(N, 1)
    ia = torch.as_tensor(iu, device=p.device)
    ib = torch.as_tensor(ju, device=p.device)
    pos = p[..., 1:3]
    d = pos[:, ia] - pos[:, ib]
    dist = torch.sqrt((d * d).sum(-1) + 1e-12)
    normal = d / dist[..., None]
    ra_, rb_ = radius[:, ia], radius[:, ib]
    depth = ra_ + rb_ - dist
    lo = pos - radius[..., None] - margin[..., None]
    hi = pos + radius[..., None] + margin[..., None]
    boxes = ((lo[:, ia] <= hi[:, ib]) & (lo[:, ib] <= hi[:, ia])).all(-1)
    valid = boxes & (depth > -(margin[:, ia] + margin[:, ib]))
    out = [normal, -normal * ra_[..., None], normal * rb_[..., None], depth,
           ia.expand(B, -1), ib.expand(B, -1), valid]
    P = ia.shape[0]
    if P <= c_max:
        pad = c_max - P
        return [torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 3
                                        else (0, pad)) for x in out]
    score = torch.where(valid, depth, float("-inf"))
    keep = torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[:, :c_max]
    return [x.gather(1, keep[..., None].expand(-1, -1, 2)) if x.dim() == 3
            else x.gather(1, keep) for x in out]
