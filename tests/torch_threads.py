"""The port's CPU tests on one torch thread.  Their tensors are small,
so one thread runs them faster than several, and the suite's workers
share the cores.  A port test module imports ``one_thread`` to use it."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
