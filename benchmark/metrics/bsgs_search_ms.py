"""The client's giant-step search a request: span ``bsgs_search`` of every
decryption (the rounds, the fetch of what they found, the sign chosen)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "serve", "bsgs_search", source="spans")
