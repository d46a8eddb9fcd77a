"""Host ms a forward step inside the port's step span, world-step cells."""
from benchmark.harness.spans import step_host_ms as read  # noqa: F401
