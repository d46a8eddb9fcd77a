"""Host ms a training step in the LCP's backward (solver.bwd span)."""
from benchmark.harness.spans import bwd_host_ms as read  # noqa: F401
