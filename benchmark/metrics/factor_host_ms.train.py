"""Host ms a training step in the rotated Schur factors of the host start,
the unfused IPM loop and the backward (solver.factor spans)."""
from benchmark.harness.spans import span_ms


def read(run):
    return span_ms(run, "solver.factor")
