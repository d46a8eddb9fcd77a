"""Test settings of the benchmark's own tests: the ``cuda`` marker and
the card fixture (decided when a test runs, never at import)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where none is present")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    was = torch.get_num_threads()
    torch.set_num_threads(min(4, was))
    yield
    torch.set_num_threads(was)
