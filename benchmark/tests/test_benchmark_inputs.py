"""The generator's draws and the reference's assembly, held against the
port's bench builders and ``make_assemble``."""
import numpy as np
import pytest
import torch

from benchmark.harness import generate, program, spec
from benchmark.reference import world as ref_world
from benchmark.tests import helpers
from benchmark.tests.helpers import configs, tiny_cell
from lcp_physics_tpu_torch.core import WorldState, make_assemble
from lcp_physics_tpu_torch.tools import bench
from lcp_physics_tpu_torch.utils import SimConfig

BIG_SEED = 2 ** 31 + 12345


def _first_cells():
    """Each traffic mix of the cells the tests run and its first cell, by
    the mix's name."""
    first = {}
    for w in helpers.bench()["workloads"]:
        first.setdefault(w["traffic"], w["name"])
    return dict(sorted(first.items()))


MIXES = _first_cells()


@pytest.mark.parametrize("mix", list(MIXES))
def test_draws_repeat_for_a_seed_and_differ_across_worlds(mix):
    """Each mix drawn for the configuration of its first cell, at 8
    worlds."""
    c = spec.cell(MIXES[mix], helpers.bench())
    traffic = c.traffic
    conf = dict(c.config, worlds=8)
    a = generate.draw(traffic, conf, BIG_SEED)
    b = generate.draw(traffic, conf, BIG_SEED)
    c = generate.draw(traffic, conf, BIG_SEED + 1)
    assert np.array_equal(a["p"], b["p"]) and np.array_equal(a["v"], b["v"])
    assert not np.array_equal(a["p"], c["p"])
    p = a["p"].reshape(-1, conf["bodies"] * 3)
    assert len({row.tobytes() for row in p}) == p.shape[0]
    if "guess" in traffic:
        for k, (lo, hi) in traffic["guess"].items():
            g = a["guess"][k]
            assert g.min() >= lo and g.max() <= hi
            assert len({row.tobytes() for row in g}) == g.shape[0]


@pytest.mark.parametrize("dense", [True, False])
def test_grid_draws_equal_the_bench_world(dense):
    """One world of the pile (loose grid) at the bench's seed 1 is the
    bench's world bit for bit."""
    mix = "pile-fwd" if dense else "loose-fwd"
    traffic = dict(spec.load_json(spec.HERE / "traffic" / f"{mix}.json"),
                   batches=1)
    d = generate.draw(traffic, {"worlds": 1, "bodies": 64}, 1)
    _, _, states = bench.build_world_scene(1, dense=dense, device="cpu")
    assert np.array_equal(d["p"][0], states.p.numpy())
    assert np.array_equal(d["v"][0], states.v.numpy())


def test_scatter_draws_equal_the_bench_lcp_worlds():
    traffic = dict(spec.load_json(spec.HERE / "traffic" / "lcp.json"),
                   batches=1)
    d = generate.draw(traffic, {"worlds": 64, "bodies": 8}, 0)
    _, _, states = bench.build_lcp_scene(64, device="cpu")
    assert np.array_equal(d["p"][0], states.p.numpy())
    assert np.array_equal(d["v"][0], states.v.numpy())


@pytest.mark.parametrize("conf_name", list(configs()))
def test_reference_assembly_equals_make_assemble(conf_name):
    """The reference's blocks are the port's, at float64, for every
    configuration with the mix of its first cell: the port's scene as its
    shape builds it (``program.scene``), the reference's bodies from the
    configuration (``ref_world.params``), at the configuration's tiny size
    (the grid at 4 x 4 with 32 slots, so that the deepest-contact
    compaction runs) and 5 worlds; a jointed configuration's equality
    rows A and b besides."""
    c = tiny_cell(configs()[conf_name])
    conf = dict(c.config, worlds=5, dtype="float64")
    traffic = dict(c.traffic, batches=1)
    d = generate.draw(traffic, conf, 77)
    f64 = torch.float64
    p = torch.as_tensor(d["p"][0], dtype=f64)
    v = torch.as_tensor(d["v"][0], dtype=f64)
    static, params = program.scene(conf, "cpu")
    assemble, _ = make_assemble(static, SimConfig())
    dt = conf["dt"]
    port, _ = assemble(params, WorldState(p, v, torch.zeros(5, dtype=f64)),
                       torch.full((5,), dt, dtype=f64))
    ref = ref_world.blocks(ref_world.params(conf, f64, "cpu"), p, v, dt)
    assert int(ref["n_contacts"].sum()) > 0
    assert ("A" in ref) == (port["A"].shape[-2] > 0)
    for k in ("Q", "p", "G", "h", "row_mask") + (("A", "b") if "A" in ref
                                                  else ()):
        torch.testing.assert_close(ref[k], port[k], rtol=0, atol=1e-12)
    torch.testing.assert_close(ref["F"], port["F"].dense(), rtol=0,
                               atol=1e-12)
