"""One intra-op torch thread while a test module runs.

The suite runs whole files side by side in worker processes (xdist,
``--dist loadfile``); a full torch thread pool in each of them
oversubscribes the cores many times over. A module takes the pin by
importing the fixture: ``from _torch_threads import one_torch_thread``.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
