"""The server's layers a request: conv, pool and FC stages, or the
single conv's inference timing (rLC checks included)."""

from benchmark import readers  # noqa: F401


def read(rec):
    ms = readers.per_step_ms(rec, "serve", "conv", "pool", "fc",
                            source="timings")
    if ms is None:
        ms = readers.per_step_ms(rec, "serve", "inference", source="timings")
    return ms
