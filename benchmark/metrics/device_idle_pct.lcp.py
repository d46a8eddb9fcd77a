"""Idle share of the traced window (%), the LCP cell."""
from benchmark.harness.readers import device_idle_pct as read  # noqa: F401
