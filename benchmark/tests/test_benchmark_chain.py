"""The chain scene kind (``scenes/chain.py``) as the ``chain16`` cell
draws it, at full size and at the tests' size: the links where the
configuration's joints put them, at angle 0 and at rest in every world;
the rain in its columns, its first rank's centres ``drop`` above the
links' centres, jittered per world, clear of the links at the start, and
falling at ``fall`` on top of the generator's normal draw.  And the
readers of the cell's two metrics on runs that hold nothing to read."""
import types

import numpy as np
import pytest

from benchmark.harness import generate, spec
from benchmark.tests.helpers import tiny_cell

CELL = "chain16-rain-train"
SEED = 2 ** 31 + 77


@pytest.mark.parametrize("size", ["full", "tiny"])
def test_links_where_the_joints_say_at_rest_and_the_rain_above(size):
    c = tiny_cell(CELL) if size == "tiny" else spec.cell(CELL)
    conf, scene = dict(c.config, worlds=8), c.traffic["scene"]
    d = generate.draw(c.traffic, conf, SEED)
    p, v = d["p"][0], d["v"][0]
    N, L = conf["bodies"], conf["links"]
    assert p.shape == v.shape == (8, N, 3)
    assert (p[..., 0] == 0).all() and (v[:, :L] == 0).all()

    at = lambda body, local: p[:, body, 1:] + np.asarray(local)
    joints = [j for j in conf["joints"] if j["kind"] == "joint"]
    linked = {j[k] for j in joints for k in ("body1", "body2") if k in j}
    assert len(joints) == L and linked == set(range(L))
    for j in joints:
        other = (at(j["body2"], j["local2"]) if j.get("body2", -1) >= 0
                 else np.asarray(j["ref"][1:]))
        np.testing.assert_allclose(at(j["body1"], j["local1"]),
                                   np.broadcast_to(other, (8, 2)), atol=1e-6)
    assert (p[:, :L] == p[:1, :L]).all()

    k = np.arange(N - L)
    cols, gap, jit = scene["rain_cols"], scene["spacing"], scene["jitter"]
    grid = np.stack([(k % cols) * gap, -scene["drop"] - (k // cols) * gap], -1)
    off = p[:, L:, 1:] - grid
    assert np.abs(off).max() <= jit and np.abs(off).min() > 0
    assert not (off == off[:1]).all()
    dist = np.linalg.norm(p[:, L:, None, 1:] - p[:, None, :L, 1:], axis=-1)
    assert dist.min() >= conf["radius"] + conf["link_radius"] - 1e-6

    fall = v[:, L:, 2] - scene["fall"]
    assert abs(fall.mean()) <= 4 * scene["vel_std"] / np.sqrt(fall.size)
    assert abs(v[:, L:, 1].mean()) <= 4 * scene["vel_std"] / np.sqrt(fall.size)


@pytest.mark.parametrize("steps, counters, want", [
    (2, {"launches.pad": 28, "launches.lu": 5}, 14.0),
    (2, {"launches.pad": 0}, 0.0), (0, {"launches.pad": 0}, None),
    (2, {"launches.lu": 5}, None)])
def test_pad_copies_read_zero_where_nothing_padded(steps, counters, want):
    """``launches.pad`` a step: 0 where nothing was padded, nothing where
    the run has no steps or the program no such counter (the parent)."""
    run = types.SimpleNamespace(steps=steps, counters=counters, timeline=None,
                                counted=lambda prefix: sum(
                                    v for k, v in counters.items()
                                    if k.startswith(prefix)))
    assert spec.reader("pad_copies_per_step.train")(run) == want
    assert spec.reader("joint_host_ms.train")(run) is None
