"""Typed proof errors and clean-failure semantics for verifiers.

Port of vpin_tpu/utils/errors.py (reference Spartan/src/errors.rs).  A
malformed proof (wrong lengths, non-canonical point encodings, bad types)
fails verification cleanly instead of raising.
"""

from __future__ import annotations

import functools
import os


class ProofVerifyError(Exception):
    """Proof verification failed."""


class R1CSError(Exception):
    """R1CS instance construction error."""


class InternalError(Exception):
    """Prover-side invariant violation (never raised by verification)."""


#: exception types a malformed or tampered proof may trigger inside a
#: verifier (bad lengths, invalid encodings, wrong types, failed checks)
_MALFORMED = (ProofVerifyError, AssertionError, ValueError, IndexError,
              KeyError, TypeError, ZeroDivisionError, OverflowError)


def verify_guard(failure=False):
    """Decorator: turn malformed-proof exceptions into a clean failure value
    (False for bool verifiers, None for Optional-returning ones).  Set
    VPIN_NO_GUARD=1 to let exceptions propagate (debugging)."""
    if os.environ.get("VPIN_NO_GUARD", "0") == "1":
        return lambda fn: fn

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except _MALFORMED:
                return failure
        return wrapper
    return deco
