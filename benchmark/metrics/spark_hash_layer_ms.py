"""The eval proof's hash layer a proof: span ``spark_hash_layer`` (the
derefs' and the leaves' evaluations and their openings)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "proof", "spark_hash_layer",
                              source="spans")
