"""Device kernels a forward step (profiler), world-step cells."""
from benchmark.harness.readers import launches_per_step as read  # noqa: F401
