"""The share of the traced window with nothing running on the card, %."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.idle_pct(rec, "proof")
