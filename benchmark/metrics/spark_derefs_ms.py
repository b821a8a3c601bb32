"""The eval proof's derefs a proof: span ``spark_derefs`` (the eq tables,
both derefs, their commitment and the memory-check challenge)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "proof", "spark_derefs", source="spans")
