"""``rows`` x ``cols`` bodies at ``spacing``, each centre jittered by
uniform(-``jitter``, ``jitter``) per world and body (the draws of
``lcp_physics_tpu_torch/tools/bench.py::build_world_scene``, made per
world instead of one world tiled)."""
import numpy as np


def positions(scene, shape, rng, config):
    """Centres (shape + (2,)) of ``shape`` = (batches, B, N) bodies."""
    rows, cols = scene["rows"], scene["cols"]
    if rows * cols != shape[-1]:
        raise ValueError(f"grid {rows} x {cols} is not {shape[-1]} bodies")
    gx, gy = np.meshgrid(np.arange(cols), np.arange(rows))
    grid = np.stack([gx.ravel(), gy.ravel()], -1) * scene["spacing"]
    j = scene["jitter"]
    return grid + rng.uniform(-j, j, tuple(shape) + (2,))


def tiny(scene):
    """The grid at the tests' CPU size: 4 x 4 of the same bodies, so a
    grid configuration's test size has 16 bodies."""
    return dict(scene, rows=4, cols=4)
