"""Host ms a training step in the hull/hull narrowphase: the pair AABB
gate, the SAT and the manifold rows (step.narrowphase.hull span)."""
from benchmark.harness.spans import span_ms


def read(run):
    return span_ms(run, "step.narrowphase.hull")
