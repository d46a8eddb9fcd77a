"""Share of device idle time inside the port's spans (%), the LCP cell."""
from benchmark.harness.spans import idle_in_program_pct as read  # noqa: F401
