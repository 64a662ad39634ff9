"""One intra-op torch thread for a port test file that imports this
fixture: in its own process and, through OMP_NUM_THREADS (which torch
reads as it starts), in the processes it starts. The suite runs the
files on parallel workers, and torch's default pool of a thread a core
in each of them oversubscribes the machine."""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_everywhere():
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
