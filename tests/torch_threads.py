"""One PyTorch intra-op thread for the test module that imports the fixture.

Under `pytest -n N` each worker's PyTorch starts a thread per core, so the
workers' thread teams oversubscribe the CPU and small ops spend most of
their time waiting on one another (a 50 ms `tiny_test` compress took 4-5 s
that way). The fixture sets one thread for the module and gives the worker
its previous count back after it. Imports torch only."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
