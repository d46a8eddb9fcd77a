"""The readers of ``harness/spans.py`` on a hand-built Chrome trace: two
steps with nested stage, solver, iteration and read spans, a backward, an
optimiser span that is not the port's, host ops among them, and device
events whose gaps fall inside and outside the port's spans."""
import types

import pytest

from benchmark.harness import spans, timeline


def _x(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}


EVENTS = [
    _x(timeline.WINDOW, 0, 1000),
    # step A: 200 us, its program children cover 170 (self 30)
    _x("step", 100, 300),
    _x("step.assemble", 110, 130),
    _x("aten::mul", 120, 125, cat="cpu_op"),
    _x("step.narrowphase", 130, 160),
    _x("step.read.contact_gate", 140, 150),
    _x("solver", 170, 270),
    _x("solver.start", 175, 185),
    _x("solver.iter", 190, 220),
    _x("solver.read.ipm_loop", 222, 226),
    _x("solver.iter", 230, 260),
    _x("step.penetration", 275, 295),
    _x("step.read.penetration_gate", 280, 290),
    # step B: 100 us, self 70
    _x("step", 400, 500),
    _x("step.integrate", 410, 440),
    _x("aten::add", 450, 480, cat="cpu_op"),
    _x("solver.bwd", 600, 700),
    _x("Optimizer.step#Adam.step", 920, 990),
    # device: idle 50-300 (middle 175, in solver), 400-700 (middle 550,
    # between the spans), 900-1000 (middle 950, in the optimiser)
    _x("k0", 0, 50, cat="kernel"),
    _x("k1", 300, 400, cat="kernel"),
    _x("k2", 700, 900, cat="kernel"),
]


def _run(events=EVENTS, steps=2):
    return types.SimpleNamespace(timeline=timeline.Timeline(events),
                                 steps=steps, calls=1)


def test_program_spans_are_the_ports_only():
    names = [n for _, _, n in spans.program_spans(_run().timeline)]
    assert len(names) == 14 and names[0] == "step"
    assert "Optimizer.step#Adam.step" not in names
    assert not any(n.startswith("aten::") for n in names)


def test_host_time_self_time_and_counts_a_step():
    run = _run()
    assert spans.step_host_ms(run) == pytest.approx((200 + 100) / 2e3)
    assert spans.step_self_ms(run) == pytest.approx((30 + 70) / 2e3)
    assert spans.solver_host_ms(run) == pytest.approx(100 / 2e3)
    assert spans.bwd_host_ms(run) == pytest.approx(100 / 2e3)
    assert spans.ipm_iters_per_step(run) == 1.0
    assert spans.host_wait_ms(run) == pytest.approx((10 + 4 + 10) / 2e3)


def test_self_time_of_a_span_whose_children_overlap():
    """Children that overlap (spans of two threads) count once."""
    ev = [_x(timeline.WINDOW, 0, 100), _x("k", 0, 1, cat="kernel"),
          _x("step", 10, 90), _x("step.assemble", 20, 50),
          _x("solver", 40, 70), _x("solver.iter", 45, 60),
          _x("step.integrate", 85, 95)]
    assert spans.step_self_ms(_run(ev, 1)) == pytest.approx(
        (80 - 50 - 5) / 1e3)


def test_idle_share_inside_the_ports_spans():
    assert spans.idle_in_program_pct(_run()) == pytest.approx(
        100.0 * 250 / (250 + 300 + 100))


def test_no_spans_no_trace_no_steps_read_nothing():
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"] == timeline.WINDOW]
    readers = [spans.step_host_ms, spans.step_self_ms, spans.solver_host_ms,
               spans.bwd_host_ms, spans.ipm_iters_per_step,
               spans.host_wait_ms, spans.idle_in_program_pct]
    for run in (_run(bare), _run(steps=0),
                types.SimpleNamespace(timeline=None, steps=2, calls=1)):
        assert [r(run) for r in readers] == [None] * len(readers)
