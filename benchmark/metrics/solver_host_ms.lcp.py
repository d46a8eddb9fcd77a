"""Host ms a call inside the port's solver span, the LCP cell."""
from benchmark.harness.spans import solver_host_ms as read  # noqa: F401
