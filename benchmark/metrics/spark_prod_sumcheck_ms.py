"""The eval proof's product-circuit sumchecks a proof: span
``spark_prod_sumcheck`` (the ops and the mem batched proofs)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "proof", "spark_prod_sumcheck",
                              source="spans")
