"""The host's rLC scalars a request: span ``rlc_scalars`` of every conv and
FC half (the PRF's rho and its bits; an FC's combined column weights and
their bits)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "serve", "rlc_scalars", source="spans")
