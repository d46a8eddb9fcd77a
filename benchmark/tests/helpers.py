"""Tiny sizes at which the CPU runs the cells in the tests, and the cells
the tests run: those of ``BENCHMARK.json`` and the pile, whose files the
benchmark keeps while ``BENCHMARK.json`` leaves it out (PERF.md)."""
import copy

from benchmark.harness import spec

PILE = {"name": "grid64-pile-fwd", "config": "grid64", "traffic": "pile-fwd",
        "chips": 1, "why": "the dense pile, kept on file"}
PILE_ROOFLINE = {"name": "world_step_roofline", "unit": "%",
                 "better": "higher", "source": "device_trace",
                 "layer": "kernels", "moves": "world_steps_per_s",
                 "workloads": [PILE["name"]]}


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

TINY = {
    "grid64": {"worlds": 6, "bodies": 16, "c_max": 32,
               "sim_config": {"max_iter": 12, "solver_eps": 1e-05,
                              "solver_stall_lim": 1, "batch_tile": 0}},
    "circles8": {"worlds": 64},
}


def tiny(cell):
    """Overrides that shrink a cell to a CPU test's size: fewer worlds
    and batches, a 4 x 4 grid of the same circles, a short rollout."""
    c = spec.cell(cell, bench())
    conf = c.config["name"]
    traffic = {"batches": min(2, c.traffic["batches"])}
    if "scene" in c.traffic and c.traffic["scene"]["kind"] == "grid":
        traffic["scene"] = dict(c.traffic["scene"], rows=4, cols=4)
    loop = c.traffic["loop"]
    if loop == "step":
        traffic.update(restart_every=3, sample={"calls": 3, "worlds": 2})
    elif loop == "lcp":
        # every LCP of the tiny batch, so that a quantile of 75% has
        # some hundreds of gaps, as at full size
        traffic.update(sample={"calls": 4, "worlds": 64})
    else:
        traffic.update(rollout_steps=3, sample={"worlds": 6})
    return {"config": copy.deepcopy(TINY[conf]), "traffic": traffic}


def tiny_cell(name):
    """The cell's :class:`spec.Cell` at the tiny size."""
    c = spec.cell(name, bench())
    for part, new in tiny(name).items():
        getattr(c, part).update(new)
    return c
