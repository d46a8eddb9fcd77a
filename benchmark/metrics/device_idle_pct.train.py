"""Idle share of the traced window (%), the parameter-inference cell."""
from benchmark.harness.readers import device_idle_pct as read  # noqa: F401
