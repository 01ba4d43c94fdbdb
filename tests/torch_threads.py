"""One intra-op thread for each test of the port.

The port's CPU tests run small PyTorch ops, for which the intra-op
thread pool mostly spins; under several test workers on a few cores
those spinning threads take the cores the other workers need.  A test
module imports ``one_torch_thread`` so that pytest applies it to each
of its tests."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run the test on one intra-op thread, then restore the count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
