"""A new configuration, body shape and cell are new files and appended
``BENCHMARK.json`` entries, their tests included; so is a jointed
configuration, with its scene and its cells of both world loops.

A copy of ``BENCHMARK.json`` and ``benchmark/`` gets a throwaway
configuration (grid64's file under another name and another shape), a
throwaway shape pair that re-exports the circle's functions, the
configuration's test size, the cell's limits, and the entries: the
configuration, the cell, and the cell's name in the ``workloads`` of each
metric that the cells of its loop report.  No file that was there changes.
The tests of the copy then take the new cell by their loops: the layout,
a tiny run that is correct, the reference against the port, and a planted
fault that the check fails.

The jointed throwaway (``tests/jointed/``, laid out as its files land in
the copy's ``benchmark/``) is a chain pinned to the world and linked by
joints, with rain falling on it: a configuration whose ``joints`` both
sides read, a shape pair that passes them to the port's scene and gives
the reference their equality rows (``reference/joints.py``), a scene kind
that reads the configuration and sets velocities and its own test size,
and a mix and a cell for each of the ``step`` and ``train`` loops.  Its
cells' limits are the pile's of the same loop."""
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys

from benchmark.harness import spec

ROOT = spec.ROOT
CONF, SHAPE, MIX = "probe16", "probedisc", "pile-fwd"
CELL = f"{CONF}-{MIX}"
LIKE_CONF, LIKE_LIMITS = "grid64", "grid64-pile-fwd"
TINY = f"benchmark/tests/tiny/{CONF}.json"
TESTS = [
    "benchmark/tests/test_benchmark_layout.py",
    f"benchmark/tests/test_benchmark_run.py::"
    f"test_result_line_keys_and_a_sound_run_is_correct[{CELL}]",
    f"benchmark/tests/test_benchmark_reference.py::"
    f"test_step_agrees_with_the_port[{CELL}]",
    f"benchmark/tests/test_benchmark_inputs.py::"
    f"test_reference_assembly_equals_make_assemble[{CONF}]",
    f"benchmark/tests/test_benchmark_run.py::"
    f"test_step_faults_fail[{CELL}-an answer altered]",
]

JOINTED = spec.HERE / "tests" / "jointed"
JCONF = "probechain"
# cell: (mix, the cell whose limits it takes)
JCELLS = {f"{JCONF}-rain-fwd": ("rain-fwd", "grid64-pile-fwd"),
          f"{JCONF}-rain-train": ("rain-train", "grid64-pile-train")}
FWD, TRAIN = JCELLS
J_TESTS = [
    "benchmark/tests/test_benchmark_layout.py",
    *(f"benchmark/tests/test_benchmark_inputs.py::"
      f"test_draws_repeat_for_a_seed_and_differ_across_worlds[{mix}]"
      for mix, _ in JCELLS.values()),
    f"benchmark/tests/test_benchmark_inputs.py::"
    f"test_reference_assembly_equals_make_assemble[{JCONF}]",
    *(f"benchmark/tests/test_benchmark_run.py::"
      f"test_result_line_keys_and_a_sound_run_is_correct[{cell}]"
      for cell in JCELLS),
    f"benchmark/tests/test_benchmark_reference.py::"
    f"test_step_agrees_with_the_port[{FWD}]",
    f"benchmark/tests/test_benchmark_reference.py::"
    f"test_inference_gradients_agree_with_the_port[{TRAIN}]",
    f"benchmark/tests/test_benchmark_run.py::"
    f"test_step_faults_fail[{FWD}-an answer altered]",
    f"benchmark/tests/test_benchmark_run.py::"
    f"test_train_fault_answer_altered[{TRAIN}]",
]


def _grow(dest, new, config, cells):
    """The checkout's benchmark in ``dest``, grown through new files and
    appended entries only: ``new`` maps paths under ``benchmark/`` to
    their text, ``config`` is the configuration's ``BENCHMARK.json``
    entry and ``cells`` the cells' entries, each cell's name appended to
    the ``workloads`` of each metric that the cells of its loop report.
    Returns the new files."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = dest / "benchmark"
    for rel, text in new.items():
        (here / rel).write_text(text)

    bench = spec.load_json(dest / "BENCHMARK.json")
    loop_of = lambda mix: spec.load_json(
        here / "traffic" / f"{mix}.json")["loop"]
    there = list(bench["workloads"])
    bench["configs"].append(config)
    for w in cells:
        bench["workloads"].append(w)
        same_loop = {v["name"] for v in there
                     if loop_of(v["traffic"]) == loop_of(w["traffic"])}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if same_loop & set(m.get("workloads", ())):
                m["workloads"].append(w["name"])
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return {f"benchmark/{rel}" for rel in new}


def _copy(dest, tiny=True):
    """The checkout's benchmark in ``dest``, grown by the throwaway cell
    through new files and appended entries only; returns the new files."""
    here = ROOT / "benchmark"
    conf = spec.load_json(here / "configs" / f"{LIKE_CONF}.json")
    new = {
        f"configs/{CONF}.json": json.dumps(dict(conf, name=CONF,
                                                shape=SHAPE)),
        f"shapes/{SHAPE}.py": (
            '"""Circles under another name."""\n'
            "from benchmark.harness import spec\n\n"
            'scene = spec.plugin("shapes", "circle").scene\n'),
        f"reference/shapes/{SHAPE}.py": (
            '"""Circles under another name."""\n'
            "from benchmark.reference.shapes.circle import (  # noqa: F401\n"
            "    contacts, margins, params)\n"),
        f"limits/{CELL}.json": (here / "limits" /
                                f"{LIKE_LIMITS}.json").read_text(),
    }
    if tiny:
        new[f"tests/tiny/{CONF}.json"] = (
            here / "tests" / "tiny" / f"{LIKE_CONF}.json").read_text()
    like = {c["name"]: c for c in spec.load_json(spec.BENCHMARK)
            ["configs"]}[LIKE_CONF]
    return _grow(dest, new,
                 dict(like, name=CONF, file=f"benchmark/configs/{CONF}.json"),
                 [{"name": CELL, "config": CONF, "traffic": MIX, "chips": 1,
                   "why": "a throwaway cell"}])


def _copy_jointed(dest):
    """The checkout's benchmark in ``dest``, grown by the jointed
    throwaway (``tests/jointed/``) and its two cells through new files
    and appended entries only; returns the new files."""
    new = {str(p.relative_to(JOINTED)): p.read_text()
           for p in JOINTED.rglob("*") if p.is_file()
           and "__pycache__" not in p.parts}
    for cell, (_, like) in JCELLS.items():
        new[f"limits/{cell}.json"] = (
            ROOT / "benchmark" / "limits" / f"{like}.json").read_text()
    config = {"name": JCONF, "source": "bench.py build_joint_scene",
              "file": f"benchmark/configs/{JCONF}.json", "reduced": [],
              "why": "a throwaway jointed configuration"}
    cells = [{"name": cell, "config": JCONF, "traffic": mix, "chips": 1,
              "why": "a throwaway jointed cell"}
             for cell, (mix, _) in JCELLS.items()]
    return _grow(dest, new, config, cells)


def _pytest(dest, tests):
    """``pytest`` on ``tests`` in ``dest``, the port importable beside it
    and the checkout's benchmark not."""
    site = dest.parent / "site"
    site.mkdir(exist_ok=True)
    if not (site / "lcp_physics_tpu_torch").exists():
        os.symlink(ROOT / "lcp_physics_tpu_torch",
                   site / "lcp_physics_tpu_torch")
    env = dict(os.environ, PYTHONPATH=str(site))
    return subprocess.run([sys.executable, "-m", "pytest",
                           "-p", "no:cacheprovider", *tests], cwd=dest,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def _only_appended(old, new):
    """``new`` is ``old`` with entries appended to its lists (a cell's name
    to a metric's ``workloads`` among them) and nothing else changed."""
    if isinstance(old, list):
        assert len(new) >= len(old)
        for a, b in zip(old, new):
            _only_appended(a, b)
    elif isinstance(old, dict):
        assert set(new) == set(old)
        for k in old:
            _only_appended(old[k], new[k])
    else:
        assert new == old


def _only_new_files_and_entries(dest, added):
    """Every file of the checkout's benchmark is in ``dest`` unchanged,
    ``added`` are the only others, and ``BENCHMARK.json`` only grew."""
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT)
            assert filecmp.cmp(path, dest / rel, shallow=False), rel
    copied = {str(p.relative_to(dest)) for p in
              (dest / "benchmark").rglob("*") if p.is_file()}
    there = {str(p.relative_to(ROOT)) for p in
             (ROOT / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert copied - there == added
    _only_appended(spec.load_json(ROOT / "BENCHMARK.json"),
                   spec.load_json(dest / "BENCHMARK.json"))


def test_a_new_configuration_is_files_and_entries(tmp_path):
    dest = tmp_path / "checkout"
    dest.mkdir()
    _only_new_files_and_entries(dest, _copy(dest))

    out = _pytest(dest, ["-v", *TESTS])
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    ran = set(re.findall(r"^(.+?) PASSED", out.stdout, re.M))
    layout = "benchmark/tests/test_benchmark_layout.py::"
    assert {layout + f"test_every_name_finds_its_files[{CELL}]",
            layout + f"test_each_cell_reports_what_the_contract_asks[{CELL}]",
            *TESTS[1:]} <= ran


def test_a_configuration_without_its_test_size_names_the_file(tmp_path):
    dest = tmp_path / "checkout"
    dest.mkdir()
    _copy(dest, tiny=False)
    out = _pytest(dest, ["-q", TESTS[1]])
    assert out.returncode != 0
    assert TINY in out.stdout, out.stdout[-4000:]


def test_a_jointed_configuration_is_files_and_entries(tmp_path):
    dest = tmp_path / "checkout"
    dest.mkdir()
    _only_new_files_and_entries(dest, _copy_jointed(dest))
    conf = spec.load_json(dest / "benchmark" / "configs" / f"{JCONF}.json")
    kinds = {(j["kind"], j.get("body2", -1) >= 0) for j in conf["joints"]}
    assert {("joint", True), ("joint", False)} <= kinds

    out = _pytest(dest, ["-v", *J_TESTS])
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    ran = set(re.findall(r"^(.+?) PASSED", out.stdout, re.M))
    layout = "benchmark/tests/test_benchmark_layout.py::"
    assert {*(layout + f"test_every_name_finds_its_files[{cell}]"
              for cell in JCELLS),
            *(layout + f"test_each_cell_reports_what_the_contract_asks"
              f"[{cell}]" for cell in JCELLS),
            *J_TESTS[1:]} <= ran
