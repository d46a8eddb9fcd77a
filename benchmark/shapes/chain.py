"""Circles linked by joints in the program: the configuration's first
``links`` bodies of radius ``link_radius``, the rest of radius
``radius``, its ``joints`` passed to the port's scene (which leaves the
pairs they link out of its contacts)."""
from __future__ import annotations

import numpy as np

from benchmark.harness import program


def radii(config):
    """(N,) radius of each body."""
    r = np.full(config["bodies"], config["radius"], np.float32)
    r[:config["links"]] = config["link_radius"]
    return r


def scene(config, device):
    """(static, params) of the configuration's jointed circle worlds."""
    N = config["bodies"]
    static = program.make_scene_static([1] * N, joints=program.joints(config),
                                       c_max=config["c_max"])
    params = program.default_params(
        static, verts=np.zeros((N, 1, 2), np.float32), radius=radii(config),
        gravity=tuple(config["gravity"]), mass=config["mass"],
        restitution=config["restitution"], fric_coeff=config["fric_coeff"],
        dtype=program.DTYPES[config["dtype"]], device=device)
    return static, params
