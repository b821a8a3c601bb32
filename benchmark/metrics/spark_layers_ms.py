"""The eval proof's hashed leaves and circuits a proof: span
``spark_layers`` (both spaces' leaves, the product and dot-product
circuits evaluated, the multiset checks and the claims)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "proof", "spark_layers", source="spans")
