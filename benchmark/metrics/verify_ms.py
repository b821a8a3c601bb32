"""The host verification a proof: span ``verify``."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "proof", "verify", source="spans")
