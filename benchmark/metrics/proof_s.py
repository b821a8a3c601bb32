"""Time a proof, proven and verified: the window over its proofs."""

from benchmark import readers  # noqa: F401


def read(rec):
    ms = readers.window_rate_ms(rec, "proof")
    return None if ms is None else ms / 1e3
