"""The port's kernels' summed bound over their summed device time, %."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.roofline_pct(rec, "serve")
