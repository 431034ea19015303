"""One intra-op thread for a port test module.

The suite runs several pytest workers on one host at once. PyTorch's CPU
operations default to a thread per core, and at the tests' small shapes
each operation's threads mostly wait for one another while the workers'
threads crowd the cores (on an 8-core host a test of a few seconds took
minutes beside five copies of itself). A port test module imports
:func:`one_torch_thread` by name, and its tests run on one thread; the
previous count comes back when the module ends (the JAX package's tests
in the same worker keep theirs). What a test compares does not depend on
it: a port-against-port check runs both sides in the module, and a
port-against-JAX check holds tolerances and knife edges."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
