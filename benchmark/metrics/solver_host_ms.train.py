"""Host ms a training step inside the solver span, the training cell."""
from benchmark.harness.spans import solver_host_ms as read  # noqa: F401
