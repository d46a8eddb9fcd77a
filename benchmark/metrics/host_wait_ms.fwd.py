"""Host ms a forward step in the port's counted reads, world-step cells."""
from benchmark.harness.spans import host_wait_ms as read  # noqa: F401
