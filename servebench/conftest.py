"""The benchmark's CPU tests run tiny models: one torch thread each keeps
them fast beside the other workers of a parallel test run."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
