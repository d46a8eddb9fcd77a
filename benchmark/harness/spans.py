"""The per-layer quantities read from the port's own spans in a traced
window: the host time of its step and solver layers, the step's self
time, the IPM iterations, the host's waits in counted reads, and the
share of the device's idle time the host spent inside the port.

The port opens a ``torch.profiler.record_function`` span at each layer
and stage while a profiler records (``utils.observe.span``); the trace
carries them as ``user_annotation`` events, which :class:`Timeline` keeps
among its host spans.  A program span's name starts with a layer of the
port (``step``, ``solver``, ``world``), and a counted host read is
``<layer>.read.<key>``.  Only ``run.timeline.host`` is read.  Every value
is per step of the window (a call, in the LCP cell); each reader returns
None where the run has no trace, no steps or no such span, as on a
program that opens none.
"""
from __future__ import annotations

import bisect

LAYERS = ("step", "solver", "world")


def program_spans(tl):
    """The window's program spans as (start, end, name), clipped to the
    window, by start (the outer of two spans that start together
    first)."""
    out = [(max(a, tl.t0), min(b, tl.t1), n) for a, b, n in tl.host
           if n.split(".", 1)[0] in LAYERS]
    out.sort(key=lambda s: (s[0], -s[1]))
    return out


def _spans(run):
    if run.timeline is None or not run.steps:
        return None
    return program_spans(run.timeline)


def _covered(spans, i):
    """The part of span ``i`` that the program spans starting inside it
    cover (their union)."""
    a, b, _ = spans[i]
    reach, total = a, 0.0
    for s, e, _ in spans[i + 1:]:
        if s >= b:
            break
        s, e = max(s, reach), min(e, b)
        if e > s:
            total += e - s
            reach = e
    return total


def _per_step(run, values):
    return sum(values) / run.steps if values else None


def span_ms(run, name):
    """Milliseconds a step inside the spans named ``name``."""
    spans = _spans(run)
    if spans is None:
        return None
    return _per_step(run, [(b - a) / 1e3 for a, b, n in spans if n == name])


def self_ms(run, name):
    """Milliseconds a step inside the spans named ``name`` and outside
    every program span within them (the layer's own Python)."""
    spans = _spans(run)
    if spans is None:
        return None
    return _per_step(run, [(b - a - _covered(spans, i)) / 1e3
                           for i, (a, b, n) in enumerate(spans) if n == name])


def span_count(run, name):
    """Spans named ``name`` a step."""
    spans = _spans(run)
    if spans is None:
        return None
    n = sum(1 for s in spans if s[2] == name)
    return n / run.steps if n else None


def host_wait_ms(run):
    """Milliseconds a step the host waited in the port's counted reads
    (``<layer>.read.<key>`` spans)."""
    spans = _spans(run)
    if spans is None:
        return None
    return _per_step(run, [(b - a) / 1e3 for a, b, n in spans
                           if n.split(".")[1:2] == ["read"]])


def idle_in_program_pct(run):
    """Share (%) of the window's device idle time whose gaps have their
    middle inside a program span: the host was in the port, not in the
    caller (its loop, autograd's engine, the optimiser)."""
    spans = _spans(run)
    if not spans:
        return None
    merged = []
    for a, b, _ in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [m[0] for m in merged]
    inside = total = 0.0
    for a, b in run.timeline.gaps():
        t = 0.5 * (a + b)
        total += b - a
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= merged[k][1]:
            inside += b - a
    return 100.0 * inside / total if total > 0 else None


def step_host_ms(run):
    return span_ms(run, "step")


def step_self_ms(run):
    return self_ms(run, "step")


def solver_host_ms(run):
    return span_ms(run, "solver")


def bwd_host_ms(run):
    return span_ms(run, "solver.bwd")


def ipm_iters_per_step(run):
    return span_count(run, "solver.iter")
