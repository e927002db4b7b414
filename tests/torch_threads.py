"""One intra-op thread for the port's CPU tests, an autouse fixture each test
file imports (``from torch_threads import one_thread``).  Their batches are
a few dozen to a few hundred chains wide, which one thread runs faster than
a pool does, and the Tier-1 command runs six pytest workers on the host's
cores, where each worker's pool of threads contends with the others'.  The
number is restored after each test."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
