"""Torch's CPU thread pool in the port's tests under pytest-xdist.

Each xdist worker starts torch's intra-op pool at one thread per core, and
XLA:CPU's pools beside it. Six workers on 8 cores then run about 48
OpenMP threads of torch alone, whose spinning waits take the cores from
each other: on an 8-core machine a test that takes 24 s on its own took
1011 s inside the six-worker run. Importing this module (every worker
collects it) caps torch's pool at the worker's share of the cores,
`cores // workers`, at least 1; outside xdist it leaves the pool as it
is.

A float32 result that depends on the thread count is held at a fixed
count instead (`torch_threads`): oneDNN's CPU convolution splits the
weight gradient's reduction over the image into one partial sum per
thread, so the FPN's full-resolution conv weight gradients move with the
count (test_torch_port_gen_train.py, FPN_THREADS).
"""

import contextlib
import os

import pytest
import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
CAP = max(1, (os.cpu_count() or 1) // WORKERS)
if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(CAP)


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with torch's intra-op pool at `n` threads, then put
    the count back."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_workers_share_the_cores():
    """Under xdist the pool holds the worker's share of the cores; alone,
    its own default."""
    if "PYTEST_XDIST_WORKER" in os.environ:
        assert torch.get_num_threads() == CAP
        assert CAP * WORKERS <= max(os.cpu_count() or 1, WORKERS)
    else:
        assert torch.get_num_threads() >= 1


@pytest.mark.parametrize("n", [1, 3])
def test_torch_threads_puts_the_count_back(n):
    before = torch.get_num_threads()
    with torch_threads(n):
        assert torch.get_num_threads() == n
    assert torch.get_num_threads() == before
    with pytest.raises(RuntimeError):
        with torch_threads(n):
            raise RuntimeError
    assert torch.get_num_threads() == before
