"""Host ms a training step in the port's counted reads."""
from benchmark.harness.spans import host_wait_ms as read  # noqa: F401
