"""One intra-op thread for the port's CPU tests, within their own module.

A port test file imports `one_torch_thread`: the plain versions then run
on one torch thread for that module's tests (a worker runs several test
processes' worth of work at once), and the process's own count comes back
after its last test. Nothing is set when a module is imported, so a test
of another file that runs after it in the same worker sees the process as
it would alone.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module's tests; the count restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
