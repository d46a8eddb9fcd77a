"""Share of a batched step's least time in its summed kernel time (%)."""
from benchmark.harness.readers import step_roofline_pct as read  # noqa: F401
