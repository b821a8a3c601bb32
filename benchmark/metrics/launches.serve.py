"""Every kernel launched on the card (PyTorch's and the port's) a step,
from the profiler's trace."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.launches(rec, "serve")
