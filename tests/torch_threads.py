"""A fixture for the port's CPU tests: one torch thread while a module runs.

The plain versions issue many small int64 ops that gain nothing from
threads, and the suite runs in several worker processes that would each
start a thread per core: oversubscribed, every op waits on its thread team
(a k = 9 proof took 15x longer than alone).  Importing the fixture into a
test module makes it apply there (it is autouse).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
