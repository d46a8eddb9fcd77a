"""Centres uniform(0, ``extent``) per world and body (the draws of
``lcp_physics_tpu_torch/tools/bench.py::build_lcp_scene``, made per
batch)."""
import numpy as np


def positions(scene, shape, rng, config):
    """Centres (shape + (2,)) of ``shape`` = (batches, B, N) bodies."""
    return rng.uniform(0, scene["extent"], tuple(shape) + (2,)).astype(
        np.float32)
