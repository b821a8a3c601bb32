"""The nearest-rank 95th percentile of every request's latency."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.percentile_ms(rec, "serve", 95)
