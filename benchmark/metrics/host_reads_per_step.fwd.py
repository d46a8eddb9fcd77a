"""Host reads a forward step (port counters), world-step cells."""
from benchmark.harness.readers import host_reads_per_step as read  # noqa: F401
