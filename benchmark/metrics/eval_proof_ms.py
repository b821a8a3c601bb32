"""The SPARK eval proof a proof: spans ``SNARK::encode`` and
``R1CSEvalProof::prove``; nothing for a transparent proof."""

from benchmark import readers  # noqa: F401


def read(rec):
    ms = readers.per_step_ms(rec, "proof", "SNARK::encode",
                            "R1CSEvalProof::prove", source="spans")
    return ms if ms else None
