"""Mean per-world IPM iterations of the LCP cell's batches."""
from benchmark.harness.readers import ipm_iterations as read  # noqa: F401
