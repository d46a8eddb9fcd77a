"""Unfused IPM iterations a training step (solver.iter spans)."""
from benchmark.harness.spans import ipm_iters_per_step as read  # noqa: F401
