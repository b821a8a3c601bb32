"""Tests of the benchmark harness.  They run on the CPU with the port's
plain versions at small sizes; tests marked ``card`` need a CUDA card and
skip without one (decided in the ``card`` fixture, never at import)."""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    from benchmark import cells
    return cells.benchmark()
