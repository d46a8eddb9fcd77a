"""Idle share of the traced window (%), forward world-step cells."""
from benchmark.harness.readers import device_idle_pct as read  # noqa: F401
