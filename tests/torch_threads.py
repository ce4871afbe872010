"""The port tests' shared ``one_torch_thread`` fixture: import it into a test
module (``from tests.torch_threads import one_torch_thread  # noqa: F401``)
and every test there runs with one intra-op thread.

The port's tests run tiny models, where more threads only oversubscribe the
cores while the suite runs in several workers. The JAX tests share
``tests/conftest.py``, so the fixture lives here instead.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests; the count before on exit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
