"""Share of the LCP batch's least time in its summed kernel time (%)."""
from benchmark.harness.readers import lcp_roofline_pct as read  # noqa: F401
