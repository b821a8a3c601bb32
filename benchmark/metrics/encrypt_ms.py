"""The client's encryptions a request (the encrypt stage; the single
conv's encrypt timing)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "serve", "encrypt", source="timings")
