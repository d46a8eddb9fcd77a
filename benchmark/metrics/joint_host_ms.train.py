"""Host ms a training step in the joints' equality rows
(``step.assemble.joints``: ``assemble_Je`` in the step's assembly; the
span opens only where the scene has joints)."""
from benchmark.harness.spans import span_ms


def read(run):
    return span_ms(run, "step.assemble.joints")
