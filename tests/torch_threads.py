"""The two-thread cap of the port's CPU test files: each imports
``two_threads``, an autouse fixture, so that a file's torch ops take two
cores beside the suite's other workers."""
import pytest
import torch


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
