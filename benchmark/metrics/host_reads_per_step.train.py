"""Host reads a training step (port counters), the parameter-inference cell."""
from benchmark.harness.readers import host_reads_per_step as read  # noqa: F401
