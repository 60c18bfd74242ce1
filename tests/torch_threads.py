"""One torch thread for a port test module: its tests and its module-scoped
fixtures.

The suite runs in several pytest-xdist workers at once, each beside JAX's
own threads; torch's default of a thread a core oversubscribes the machine,
and a torch test then runs many times slower than alone. A test module
takes this fixture with `from torch_threads import one_torch_thread_module`.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread_module():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
