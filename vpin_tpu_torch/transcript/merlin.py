"""merlin transcripts + the Spartan ProofTranscript extension.

Port of vpin_tpu/transcript/merlin.py, byte-compatible with merlin 3.0: every
label is wire format (reference Spartan/src/transcript.rs).  RandomTape is the
prover's private randomness (Spartan/src/random.rs), with an optional
deterministic seed for reproducible proofs.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..field.prime_field import FQ
from .strobe import Strobe128


def _u32le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    def __init__(self, label: bytes, log: Optional[list] = None):
        self.strobe = Strobe128(b"Merlin v1.0")
        #: optional challenge-stream recorder: list of (label, hex bytes)
        #: appended on every challenge (crosscheck golden vectors)
        self.log = log
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(message)), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        out = self.strobe.prf(n, False)
        if self.log is not None:
            self.log.append((label.decode("latin1"), out.hex()))
        return out

    # -- Spartan ProofTranscript extension (transcript.rs:12-60) --------

    def append_protocol_name(self, name: bytes) -> None:
        self.append_message(b"protocol-name", name)

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.append_message(label, FQ.to_bytes(scalar))

    def append_point(self, label: bytes, compressed: bytes) -> None:
        if len(compressed) != 32:
            raise ValueError("a compressed point is 32 bytes")
        self.append_message(label, compressed)

    def challenge_scalar(self, label: bytes) -> int:
        return FQ.from_bytes_wide(self.challenge_bytes(label, 64))

    def challenge_vector(self, label: bytes, n: int) -> List[int]:
        return [self.challenge_scalar(label) for _ in range(n)]

    # -- checkpoint support ---------------------------------------------

    def snapshot(self) -> tuple:
        return self.strobe.snapshot()

    def restore(self, snap: tuple) -> None:
        self.strobe.restore(snap)


class RandomTape:
    """Prover-private randomness tape (a second transcript seeded with a
    random scalar)."""

    def __init__(self, name: bytes, seed: Optional[int] = None):
        self.tape = Transcript(name)
        init = seed if seed is not None else FQ.from_bytes_wide(os.urandom(64))
        self.tape.append_scalar(b"init_randomness", init)

    def random_scalar(self, label: bytes) -> int:
        return self.tape.challenge_scalar(label)

    def random_vector(self, label: bytes, n: int) -> List[int]:
        return self.tape.challenge_vector(label, n)

    def snapshot(self) -> tuple:
        return self.tape.snapshot()

    def restore(self, snap: tuple) -> None:
        self.tape.restore(snap)
