import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The CPU tests run beside the suite's other workers: intra-op
    threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
