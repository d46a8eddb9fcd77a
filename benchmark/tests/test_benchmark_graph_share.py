"""``metrics/graph_iter_share.train.py`` on hand-built traces: every pass
replayed, half of them, and a program that opens no ``solver.graph`` span
(the reader then returns None and does not raise)."""
import types

import pytest

from benchmark.harness import spec, timeline

read = spec.reader("graph_iter_share.train")


def _x(name, ts, end, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}


def _run(passes, graphed, steps=2):
    """``steps`` steps of ``passes`` solver.iter spans each, the first
    ``graphed`` of each step with a solver.graph span inside."""
    ev = [_x(timeline.WINDOW, 0, 10_000), _x("k", 0, 1, cat="kernel")]
    t = 10
    for _ in range(steps):
        ev.append(_x("solver", t, t + 100 * passes + 10))
        for i in range(passes):
            a = t + 5 + 100 * i
            ev.append(_x("solver.iter", a, a + 90))
            if i < graphed:
                ev.append(_x("solver.graph", a + 10, a + 80))
        t += 100 * passes + 50
    return types.SimpleNamespace(timeline=timeline.Timeline(ev), steps=steps,
                                 calls=1)


@pytest.mark.parametrize("passes,graphed,share", [(12, 12, 100.0),
                                                  (12, 6, 50.0)])
def test_share_of_replayed_passes(passes, graphed, share):
    assert read(_run(passes, graphed)) == pytest.approx(share)


def test_no_graph_span_reads_nothing():
    assert read(_run(12, 0)) is None
    assert read(types.SimpleNamespace(timeline=None, steps=2,
                                      calls=1)) is None
