"""One torch thread for a test module of the port: each tests/test_torch_*
file imports one_torch_thread, a module-scoped autouse fixture. The suite
runs on several workers at once, and the port's CPU tests work on small
tensors, where more intra-op threads buy nothing and contend with the
other workers (tests/test_torch_ba.py alone: 92.6 s on the default eight
threads, 49.9 s on one). The count is restored when the module ends."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
