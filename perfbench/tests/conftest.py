import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture(autouse=True)
def _few_threads():
    """The small runs here are tiny: many CPU threads a worker only
    contend with the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
