"""A fixture shared by the port's CPU test files."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests. With six test workers
    sharing a CPU, the port's plain CPU paths (thousands of tiny ops) spend
    their time in intra-op thread barriers: one test ran about nine times
    slower with torch's default thread count than with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
