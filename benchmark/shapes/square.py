"""Squares in the program: N ``width`` x ``height`` boxes a world, 4-vertex
hulls of radius 0 (the engine's Hull bodies), with the configuration's
shared parameters; the inertia is the port's ``polygon_inertia``."""
from __future__ import annotations

import numpy as np

from benchmark.harness import program


def corners(config):
    """The local vertices (4, 2) of a square, counter-clockwise from the
    lower left corner."""
    w, h = 0.5 * config["width"], 0.5 * config["height"]
    return np.array([[-w, -h], [w, -h], [w, h], [-w, h]], np.float32)


def scene(config, device):
    """(static, params) of the configuration's square worlds."""
    N = config["bodies"]
    static = program.make_scene_static([4] * N, c_max=config["c_max"])
    params = program.default_params(
        static, verts=np.broadcast_to(corners(config), (N, 4, 2)).copy(),
        radius=np.zeros(N, np.float32), gravity=tuple(config["gravity"]),
        mass=config["mass"], restitution=config["restitution"],
        fric_coeff=config["fric_coeff"],
        dtype=program.DTYPES[config["dtype"]], device=device)
    return static, params
