from .errors import InternalError, ProofVerifyError, R1CSError, verify_guard
from .timer import Timer, span

__all__ = ["InternalError", "ProofVerifyError", "R1CSError", "verify_guard",
           "Timer", "span"]
