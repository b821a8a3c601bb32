"""The sat proof a proof: spans ``witness_commit`` and
``R1CSProof::prove``."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "proof", "witness_commit",
                              "R1CSProof::prove", source="spans")
