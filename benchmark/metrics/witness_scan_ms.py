"""The gadget (witness and R1CS instance) a proof: span ``gadget``."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "proof", "gadget", source="spans")
