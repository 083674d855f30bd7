import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written kernels); skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    """The benchmark's tests run at small sizes, where torch's thread pool
    only contends with the other test workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
