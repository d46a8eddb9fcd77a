"""Circles linked by joints in the reference: the circle's narrowphase
over the pairs that no joint links, and the joints' equality rows, both
from the configuration's ``joints``; the first ``links`` bodies have
radius ``link_radius``, the rest ``radius``."""
from __future__ import annotations

import torch

from benchmark.reference import joints
from benchmark.reference.shapes import circle

contacts = circle.contacts


def params(config, dtype, device):
    """The ``world`` dict: the circle's, with per-body radii and
    inertias, the joints and the pairs they leave to the narrowphase."""
    N, L = config["bodies"], config["links"]
    r = torch.full((N,), float(config["radius"]), dtype=dtype, device=device)
    r[:L] = config["link_radius"]
    return dict(circle.params(config, dtype, device), shape="chain",
                radius=r, inertia=0.5 * config["mass"] * r * r,
                joints=config["joints"],
                pairs=joints.contact_pairs(N, config["joints"]))


def equality(world, p):
    """A (B, q, 3N) and b (B, q) of the world's joints at positions p."""
    return joints.rows(world["joints"], p)
