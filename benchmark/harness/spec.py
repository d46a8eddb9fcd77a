"""What ``BENCHMARK.json`` names, and the files each name leads to.

A cell (``workloads`` entry) names a configuration, whose file is given by
``configs[].file``, and a traffic mix, read from ``traffic/<mix>.json``;
its limits are ``limits/<cell>.json``.  The code a cell runs is found the
same way, by the names its files give:

* a traffic mix's ``loop`` is ``loops/<loop>.py`` (its ``Loop``: what a
  call does, what the window leaves for the check, and the reference's
  side of the check);
* its ``scene.kind`` is ``scenes/<kind>.py`` (the draw of positions);
* a configuration's ``shape`` is ``shapes/<shape>.py`` (the program's
  scene) and ``reference/shapes/<shape>.py`` (the reference's bodies and
  narrowphase);
* a per-layer metric's reader is ``metrics/<metric>.py``.

Nothing else is looked up, so a cell, a mix, a loop, a scene, a shape or a
metric is added by adding files and entries, never by editing one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                      # the checkout
BENCHMARK = ROOT / "BENCHMARK.json"


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell with everything its run reads."""

    name: str
    config: dict          # the configuration file's object
    traffic: dict         # the traffic mix's object
    limits: dict          # number -> limit of the correctness check
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def reports(metric, cell, e2e_names):
    """Whether ``cell`` reports ``metric`` (an entry of BENCHMARK.json):
    listed in its ``workloads``, or, without that key, wherever the
    end-to-end metric it moves (or, for an end-to-end metric, every
    cell) is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def cell(name, bench=None):
    """The :class:`Cell` named ``name`` in ``bench`` (default: the
    checkout's BENCHMARK.json)."""
    bench = bench if bench is not None else load_json(BENCHMARK)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def plugin(folder, name):
    """The module ``benchmark/<folder>/<name>.py``, loaded once (a name may
    hold ``.`` and ``-``, so it is loaded from its file)."""
    key = "benchmark._found." + ".".join(folder.split("/")) + "." + \
        name.replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in the benchmark")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def loop(name):
    """The ``Loop`` class of ``loops/<name>.py``."""
    return plugin("loops", name).Loop


def reader(metric_name):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    return plugin("metrics", metric_name).read
