"""Tiny sizes at which the CPU runs the cells in the tests, and the cells
the tests run: those of ``BENCHMARK.json`` and the pile, whose files the
benchmark keeps while ``BENCHMARK.json`` leaves it out (PERF.md).

A configuration's test size is ``tests/tiny/<config>.json``, found by the
configuration's name as ``spec.plugin`` finds code by name: the entries of
the configuration file that the tests replace.  A scene kind that has a
test size of its own gives it (``scenes/<kind>.py``'s ``tiny``: the grid
is cut to 4 x 4, so a tiny grid configuration has 16 bodies)."""
import copy

from benchmark.harness import spec

TINY = spec.HERE / "tests" / "tiny"

PILE = {"name": "grid64-pile-fwd", "config": "grid64", "traffic": "pile-fwd",
        "chips": 1, "why": "the dense pile, kept on file"}
PILE_ROOFLINE = {"name": "world_step_roofline", "unit": "%",
                 "better": "higher", "source": "device_trace",
                 "layer": "kernels", "moves": "world_steps_per_s",
                 "workloads": [PILE["name"]]}

# What each loop's tiny run draws and samples, by the loop's name.
LOOP_TINY = {
    "step": {"restart_every": 3, "sample": {"calls": 3, "worlds": 2}},
    # every LCP of the tiny batch, so that a quantile of 75% has some
    # hundreds of gaps, as at full size
    "lcp": {"sample": {"calls": 4, "worlds": 64}},
    "train": {"rollout_steps": 3, "sample": {"worlds": 6}},
}


def bench():
    """``BENCHMARK.json`` with the pile cell and its roofline added: the
    pile reports what the loose grid reports."""
    b = spec.load_json(spec.BENCHMARK)
    b["workloads"] = b["workloads"] + [PILE]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and "grid64-loose-fwd" in m["workloads"]:
            m["workloads"] = m["workloads"] + [PILE["name"]]
    b["per_layer"] = b["per_layer"] + [PILE_ROOFLINE]
    return b


def cells(loop=None):
    """The names of the cells the tests run (``bench()``), in its order;
    with ``loop``, those whose traffic mix runs ``loops/<loop>.py``."""
    b = bench()
    return [w["name"] for w in b["workloads"]
            if loop is None or spec.cell(w["name"], b).traffic["loop"] == loop]


def configs():
    """Each configuration of ``bench()`` and the name of its first cell,
    a dict in ``bench()``'s order."""
    first = {}
    for w in bench()["workloads"]:
        first.setdefault(w["config"], w["name"])
    return first


def tiny_config(name):
    """The test size of configuration ``name``: ``tiny/<name>.json``."""
    path = TINY / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {name!r} has no test size: add "
            f"{path.relative_to(spec.ROOT)}")
    return spec.load_json(path)


def tiny(cell):
    """Overrides that shrink a cell to a CPU test's size: the
    configuration's ``tiny/<config>.json``, at most two batches, the
    scene's own test size where its kind has one, the loop's short run
    and small sample."""
    c = spec.cell(cell, bench())
    traffic = {"batches": min(2, c.traffic["batches"])}
    if "scene" in c.traffic:
        kind = spec.plugin("scenes", c.traffic["scene"]["kind"])
        if hasattr(kind, "tiny"):
            traffic["scene"] = kind.tiny(c.traffic["scene"])
    traffic.update(copy.deepcopy(LOOP_TINY[c.traffic["loop"]]))
    return {"config": tiny_config(c.config["name"]), "traffic": traffic}


def tiny_cell(name):
    """The cell's :class:`spec.Cell` at the tiny size."""
    c = spec.cell(name, bench())
    for part, new in tiny(name).items():
        getattr(c, part).update(new)
    return c
