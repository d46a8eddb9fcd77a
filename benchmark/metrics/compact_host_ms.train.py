"""Host ms a training step in the compaction of the contact rows to the
c_max deepest (step.narrowphase.compact span; it opens only when the rows
exceed c_max)."""
from benchmark.harness.spans import span_ms


def read(run):
    return span_ms(run, "step.narrowphase.compact")
