"""A run's result line, its exits, and `correct` coming out false when the
timed path is broken underneath or the control stands in for it.  The
runs here are on the CPU at tiny sizes (``helpers.tiny``); the look for a
card is skipped by calling ``run`` with ``device="cpu"``."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import check, program, spec
from benchmark.tests.helpers import bench, cells, tiny, tiny_cell

ROOT = spec.ROOT
CELLS = cells()
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=0, seed=2 ** 33 + 7, seconds=0.5):
    return bench_run.run(cell, seed, seconds, trace, device="cpu",
                         overrides=tiny(cell), t_start=time.perf_counter(),
                         bench=bench())


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys_and_a_sound_run_is_correct(cell):
    res = _run(cell)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = {m["name"] for m in spec.cell(cell, bench()).end_to_end}
    assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(res["checks"]) == set(spec.cell(cell, bench()).limits)
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_only_per_layer_metrics(cell):
    res = _run(cell, trace=1)
    assert list(res) == KEYS + ["checks"]
    layer = {m["name"] for m in spec.cell(cell, bench()).per_layer}
    assert res["metrics"] and set(res["metrics"]) <= layer


def test_no_card_no_result():
    """Without a CUDA device the command exits nonzero and prints
    nothing on standard output."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder the command exits nonzero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""


# --- faults planted in the timed path --------------------------------------

def _unchanged(static, config, params_batched=False):
    return lambda params, s, dt: (s, None)


def _wrap_step(edit):
    real = program.batched_step

    def make(static, config, params_batched=False):
        step = real(static, config, params_batched)

        def broken(params, s, dt):
            out, diag = step(params, s, dt)
            return edit(s, out), diag
        return broken
    return make


def _half(s, out):
    """The second half of the worlds left out: returned unstepped."""
    h = s.p.shape[0] // 2
    return program.WorldState(torch.cat([out.p[:h], s.p[h:]]),
                              torch.cat([out.v[:h], s.v[h:]]), out.t)


def _altered(s, out):
    """Every world's body 0 moved by 0.05 in x where the step makes it."""
    p = out.p.clone()
    p[:, 0, 1] += 0.05
    return program.WorldState(p, out.v, out.t)


STEP_FAULTS = {"state unchanged": _unchanged, "half the batch left out":
               _wrap_step(_half), "an answer altered": _wrap_step(_altered)}


@pytest.mark.parametrize("fault", list(STEP_FAULTS))
@pytest.mark.parametrize("cell", cells("step"))
def test_step_faults_fail(cell, fault, monkeypatch):
    monkeypatch.setattr(program, "batched_step", STEP_FAULTS[fault])
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", cells("lcp"))
def test_lcp_fault_answers_altered(cell, monkeypatch):
    """A solver cell can have one of the faults: answers altered where
    they are produced (every z of a batch scaled by 1.01).  It has no
    state to leave unchanged and no mean over the batch."""
    real = program.lcp_solve
    monkeypatch.setattr(program, "lcp_solve",
                        lambda *a, **kw: real(*a, **kw) * 1.01)
    assert _run(cell)["correct"] is False


def test_lcp_fault_in_a_part_of_the_batch(monkeypatch):
    """Answers altered in one LCP of every three of a batch (z scaled by
    1.01): under half, so the median alone would pass them."""
    real = program.lcp_solve

    def part(*a, **kw):
        z = real(*a, **kw)
        hit = (torch.arange(z.shape[0]) % 3 == 0).to(z.device)
        return torch.where(hit[:, None], z * 1.01, z)
    monkeypatch.setattr(program, "lcp_solve", part)
    res = _run("circles8-lcp")
    assert res["checks"]["z_gap_median"]["value"] <= \
        res["checks"]["z_gap_median"]["limit"]
    assert res["correct"] is False


@pytest.mark.parametrize("cell", cells("train"))
def test_train_fault_state_unchanged(cell, monkeypatch):
    """Adam's step runs but the guesses are put back: the state is
    returned unchanged."""
    real = torch.optim.Adam.step

    def step(self, closure=None):
        saved = [p.detach().clone() for g in self.param_groups
                 for p in g["params"]]
        real(self, closure)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups
                             for p in g["params"]), saved):
                p.copy_(s)
    monkeypatch.setattr(torch.optim.Adam, "step", step)
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell", cells("train"))
def test_train_fault_half_the_batch(cell, monkeypatch):
    train = spec.loop("train")
    real = train.loss

    def half(self):
        loss = real(self)
        w = torch.zeros_like(loss)
        w[:loss.shape[0] // 2] = 2.0
        return loss * w
    monkeypatch.setattr(train, "loss", half)
    assert _run(cell)["correct"] is False


def _altered_in_training(s, out):
    """``_altered`` in the training call's differentiable steps only (the
    set-up's target rollout runs without gradients)."""
    return _altered(s, out) if torch.is_grad_enabled() else out


@pytest.mark.parametrize("cell", cells("train"))
def test_train_fault_answer_altered(cell, monkeypatch):
    monkeypatch.setattr(program, "batched_step",
                        _wrap_step(_altered_in_training))
    assert _run(cell)["correct"] is False


# --- the control in the program's place -------------------------------------

def _control_fails(cell, device, seeds):
    for seed in seeds:
        c = tiny_cell(cell)
        loop = spec.loop(c.traffic["loop"])(c, seed, device)
        loop.setup()
        if c.traffic["loop"] != "train":
            for _ in range(4):
                loop.call()
        ev = loop.evidence()
        loop.free()
        numbers, _ = loop.compare(check.stand_in(loop, ev, "control"),
                                  loop.reference(ev))
        assert any(numbers[k] > c.limits[k] for k in numbers), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    _control_fails(cell, "cpu", [11, 12, 13])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    _control_fails(cell, card, [11, 12, 13])
