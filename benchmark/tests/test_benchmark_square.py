"""The reference's square narrowphase (``reference/shapes/square.py``)
against the port's ``find_contacts``, row by row at float64 on the CPU,
through the port's own contact stage (``make_assemble``, its speculative
margins included) on the configuration's squares: face against face,
vertex against face, both rotated, a pair separated inside its margin and
one outside it (its boxes overlapping), and an axis-aligned tie that the
compaction cuts."""
import math

import pytest
import torch

from benchmark.harness import program, spec
from benchmark.reference import world as ref_world
from lcp_physics_tpu_torch.core import WorldState, make_assemble
from lcp_physics_tpu_torch.utils import SimConfig

F64 = torch.float64
DT = 0.01
CONF = spec.load_json(spec.HERE / "configs" / "hull64.json")

# name: (poses [angle, x, y] a body, velocities [omega, vx, vy], c_max,
# valid rows, True where every valid row overlaps (depth > 0))
CASES = {
    "face-face": ([[0, 0, 0], [0, 1.9, 0.3]], [[0, 0, 0], [0, -0.5, 0]],
                  8, 2, True),
    "vertex-face": ([[0, 0, 0], [math.pi / 4, 0.2, 2.3]],
                    [[0, 0, 0], [0, 0, 0]], 8, 1, True),
    "rotated": ([[0.3, 0, 0], [-0.7, 1.7, 0.9]], [[0.4, 0.1, 0.2],
                                                  [-0.3, -0.2, 0.1]],
                8, 1, True),
    "separated inside the margin": ([[0, 0, 0], [0, 2.005, 0.2]],
                                    [[0, 0, 0], [0, -1.0, 0]], 8, 2,
                                    False),
    "separated outside the margin": ([[0, 0, 0], [math.pi / 4, 2.3, 2.3]],
                                     [[0, 0, 0], [0, 0, 0]], 8, 0, None),
    "axis-aligned tie, compacted": ([[0, 0, 0], [0, 1.5, 0], [0, 3.0, 0]],
                                    [[0, 0, 0]] * 3, 3, 3, True),
}


def _contacts(poses, vels, c_max):
    p = torch.tensor([poses], dtype=F64)
    v = torch.tensor([vels], dtype=F64)
    conf = dict(CONF, bodies=p.shape[1], c_max=c_max, dtype="float64")
    static, params = program.scene(conf, "cpu")
    assemble, _ = make_assemble(static, SimConfig())
    state = WorldState(p, v, torch.zeros(1, dtype=F64))
    port, _ = assemble.contacts(params, state,
                                torch.full((1,), DT, dtype=F64))
    world = ref_world.params(conf, F64, "cpu")
    ref = ref_world.shape("square").contacts(world, p, v, DT)
    return port, ref


@pytest.mark.parametrize("case", list(CASES))
def test_square_contacts_match_the_port(case):
    poses, vels, c_max, n_valid, touching = CASES[case]
    port, ref = _contacts(poses, vels, c_max)
    for name, a, b in zip(port._fields, port, ref):
        assert a.shape == b.shape, name
        if a.dtype in (torch.bool, torch.int64):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(b, a, rtol=0, atol=1e-12, msg=name)
    valid = ref[6][0]
    assert int(valid.sum()) == n_valid
    depth = ref[3][0][valid]
    if touching is not None:
        assert bool((depth > 0).all()) == touching
        assert bool((depth < 0).all()) == (not touching)


def test_the_tie_is_cut_in_row_order():
    """Four rows of the same depth (two pairs overlapping by 0.5) and
    three slots: both keep pair (0, 1)'s two points and pair (1, 2)'s
    first."""
    poses, vels, c_max, _, _ = CASES["axis-aligned tie, compacted"]
    port, ref = _contacts(poses, vels, c_max)
    full, _ = _contacts(poses, vels, 6)
    kept = full.valid[0]
    assert int(kept.sum()) == 4
    assert len(set(full.depth[0][kept].tolist())) == 1
    for c in (port, ref):
        assert c[4][0].tolist() == [0, 0, 1] and c[5][0].tolist() == [1, 1, 2]
    assert torch.equal(port.ra[0], full.ra[0][kept][:3])
