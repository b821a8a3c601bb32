"""The whole window over the requests completed in it."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.window_rate_ms(rec, "serve")
