"""The client's decryptions a request (the pipeline's decrypt stage,
timed to a device synchronize in a traced run)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "serve", "decrypt", source="timings")
