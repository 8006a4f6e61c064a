"""One torch intra-op thread for the port's CPU tests. The suite runs in
several worker processes on a few cores; torch's default (a thread per
core in every worker) oversubscribes the machine, and its idle threads
spin, which slows these tiny-tensor tests and every other worker's.
Test modules opt in with `from torch_threads import one_torch_thread`.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
