"""BENCHMARK.json against the benchmark's contract, and every name it
gives against the file the harness finds by it."""
import json
import re

import pytest

from benchmark.harness import spec
from benchmark.reference import world as ref_world
from benchmark.tests.helpers import bench

BENCH = spec.load_json(spec.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
# the cells of BENCHMARK.json and those kept on file (helpers.bench)
ALL = [w["name"] for w in bench()["workloads"]]


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.endswith("_torch")
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + list(CONFIGS)
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"]) and w["config"] in CONFIGS
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] == 0.25


@pytest.mark.parametrize("cell", ALL)
def test_every_name_finds_its_files(cell):
    c = spec.cell(cell, bench())
    work = {w["name"]: w for w in bench()["workloads"]}[cell]
    conf = CONFIGS[work["config"]]
    assert conf["file"].startswith(BENCH["paths"][0] + "/")
    assert c.config["name"] == work["config"]
    assert sorted(c.config["reduced"]) == sorted(conf["reduced"])
    loop = spec.loop(c.traffic["loop"])
    assert set(c.limits) == set(loop.numbers)
    assert callable(spec.plugin("scenes", c.traffic["scene"]["kind"])
                    .positions)
    assert callable(spec.plugin("shapes", c.config["shape"]).scene)
    assert callable(ref_world.shape(c.config["shape"]).contacts)
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("cell", ALL)
def test_each_cell_reports_what_the_contract_asks(cell):
    c = spec.cell(cell, bench())
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_configs_used_and_per_layer_moves_exist():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(CONFIGS)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in CELLS
            assert spec.reports(e2e[m["moves"]], w, ())
    same_layer = {}
    for m in BENCH["per_layer"]:
        same_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in same_layer.values())
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
