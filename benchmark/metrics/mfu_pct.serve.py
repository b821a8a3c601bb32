"""The protocol's 32-bit multiplies (work/counts.py) over the window at
the card's peak multiply rate, %."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.mfu_pct(rec, "serve")
