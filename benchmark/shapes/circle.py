"""Circles in the program: N radius-``radius`` circles a world, with the
configuration's shared parameters."""
from __future__ import annotations

import numpy as np

from benchmark.harness import program


def scene(config, device):
    """(static, params) of the configuration's circle worlds."""
    N = config["bodies"]
    static = program.make_scene_static([1] * N, c_max=config["c_max"])
    params = program.default_params(
        static, verts=np.zeros((N, 1, 2), np.float32),
        radius=np.full(N, config["radius"], np.float32),
        gravity=tuple(config["gravity"]), mass=config["mass"],
        restitution=config["restitution"], fric_coeff=config["fric_coeff"],
        dtype=program.DTYPES[config["dtype"]], device=device)
    return static, params
