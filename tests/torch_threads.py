"""One intra-op torch thread for the port's CPU tests.

The test run's workers share the host's cores, and each process's torch
keeps a pool of one thread a core whose threads spin while they wait for
work. On the port's small test shapes, made of many small ops, the pool
buys little or no time alone and burns several times the CPU that the
other workers need, so every port test module runs on one thread.
``OMP_NUM_THREADS`` goes to the processes a test starts too, so that a
result compared bit for bit across processes is summed alike in each.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread, here and in the processes the module's
    tests start, for the module's tests; restored after them."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
