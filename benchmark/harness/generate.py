"""The one generator of every traffic mix: worlds drawn per world from the
seed, as a traffic file's ``scene`` describes them.

The scene's ``kind`` names the module of its draw, ``scenes/<kind>.py``
(``grid``, ``scatter``): ``positions(scene, shape, rng, config)``, the
bodies' centres, drawn for the configuration the worlds are made for.
Velocities are normal(0, ``vel_std``) per world and body (zero when
``vel_std`` is 0); a kind that sets some bodies' velocities otherwise
(bodies at rest, a speed added) defines ``velocities(scene, v, config)``,
which changes the drawn velocities without drawing more.  Angles start at
0, whatever the kind.  All draws of a run come from one
``numpy.random.default_rng(seed)`` in a fixed order (positions of every
batch, then velocities, then any per-world guesses), so a seed gives the
same worlds on every machine; any whole number is a seed.  A kind may
also define ``tiny(scene)``, the scene at the tests' CPU size.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import spec


def worlds(scene, batches, config, rng):
    """(p, v), each (batches, B, N, 3) float32, of ``scene`` for the
    configuration ``config`` (its ``worlds`` B and ``bodies`` N)."""
    kind = spec.plugin("scenes", scene["kind"])
    shape = (batches, config["worlds"], config["bodies"])
    pos = kind.positions(scene, shape, rng, config)
    std = scene["vel_std"]
    if std > 0:
        v = rng.normal(0, std, shape + (3,)).astype(np.float32)
    else:
        v = np.zeros(shape + (3,), np.float32)
    if hasattr(kind, "velocities"):
        v = kind.velocities(scene, v, config).astype(np.float32)
    p = np.concatenate([np.zeros(shape + (1,)), pos], -1).astype(np.float32)
    return p, v


def guesses(ranges, B, N, rng):
    """Per-world, per-body guesses {name: (B, N) float32} drawn
    uniform(lo, hi) in the order of ``ranges``."""
    return {k: rng.uniform(lo, hi, (B, N)).astype(np.float32)
            for k, (lo, hi) in ranges.items()}


def draw(traffic, config, seed):
    """Everything the traffic mix draws for ``seed``: a dict with p, v
    (batches, B, N, 3) and, for a mix with ``guess`` ranges, the guesses."""
    rng = np.random.default_rng(seed)
    out = {}
    out["p"], out["v"] = worlds(traffic["scene"], traffic["batches"],
                                config, rng)
    if "guess" in traffic:
        out["guess"] = guesses(traffic["guess"], config["worlds"],
                               config["bodies"], rng)
    return out
