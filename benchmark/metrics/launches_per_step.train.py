"""Device kernels a training step (profiler), the parameter-inference cell."""
from benchmark.harness.readers import launches_per_step as read  # noqa: F401
