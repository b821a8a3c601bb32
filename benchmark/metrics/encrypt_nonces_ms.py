"""The host's part of the client's encryptions a request: span
``encrypt_nonces`` (the nonce draws, the digits of the nonces and of |m|,
the sign mask)."""

from benchmark import readers  # noqa: F401


def read(rec):
    return readers.per_step_ms(rec, "serve", "encrypt_nonces", source="spans")
