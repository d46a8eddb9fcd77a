"""Host ms a training step in the step span outside its stages."""
from benchmark.harness.spans import step_self_ms as read  # noqa: F401
