"""Helpers shared by the port's CPU tests (tests/test_torch_*.py)."""

import contextlib
import os

import pytest
import torch


@contextlib.contextmanager
def one_thread_under_xdist():
    """`one_thread` as a context manager, for module-scoped fixtures."""
    if int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")) <= 1:
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def one_thread():
    """Under several test workers (pytest-xdist), run the test with torch
    on one intra-op thread, then restore the count; alone, leave it as it
    is. Tests built from many small ops pay a thread synchronisation an
    op: under the six test workers on eight cores, a thread a core made
    such a test 100-1000x slower than alone (a 1.2 s K9 emulation took
    612 s) and loaded the cores every other worker needs, while alone the
    threads win (one thread made a large K9 or K3 emulation case ~0.4 s
    slower). The tests that take this fixture compare integer or
    elementwise results, or hold tolerances set by the order of f32 sums,
    so the thread count moves nothing they check."""
    with one_thread_under_xdist():
        yield
