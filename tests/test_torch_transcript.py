"""The port's transcript (vpin_tpu_torch/transcript) against merlin's published
vectors and against vpin_tpu's Transcript and RandomTape.

Tolerance: exact.  Challenge bytes are wire format: every stream must be
byte-equal to vpin_tpu's for the same labels, messages and scalars.
"""

import hashlib

import numpy as np
import pytest

from vpin_tpu.transcript.merlin import (
    RandomTape as JRandomTape, Transcript as JTranscript,
)
from vpin_tpu_torch.field.prime_field import FQ, L_MODULUS
from vpin_tpu_torch.transcript import RandomTape, Transcript, sha3_256


def test_keccak_via_sha3():
    for msg in [b"", b"abc", b"The quick brown fox", b"x" * 1000]:
        assert sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_merlin_equivalence_simple():
    # merlin 3.0, tests::transcript_equivalence_simple
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    ch = t.challenge_bytes(b"challenge", 32)
    assert ch.hex() == ("d5a21972d0d5fe320c0d263fac7fffb8"
                        "145aa640af6e9bca177c03c7efcf0615")


def test_spartan_extension_and_tape():
    t = Transcript(b"snark_example")
    t.append_protocol_name(b"Spartan SNARK proof")
    s = t.challenge_scalar(b"challenge_tau")
    assert 0 <= s < L_MODULUS
    v = t.challenge_vector(b"challenge_tau", 3)
    assert len(v) == 3 and len(set(v)) == 3
    a = RandomTape(b"proof", seed=42).random_vector(b"v", 4)
    assert a == RandomTape(b"proof", seed=42).random_vector(b"v", 4)
    assert a != RandomTape(b"proof", seed=43).random_vector(b"v", 4)


def test_byte_helpers():
    v = L_MODULUS - 5
    assert FQ.from_bytes(FQ.to_bytes(v)) == v
    with pytest.raises(ValueError):
        FQ.from_bytes(L_MODULUS.to_bytes(32, "little"))
    assert FQ.from_bytes_mod_order(b"\xff" * 32) == (2**256 - 1) % L_MODULUS
    assert FQ.from_bytes_wide(b"\xff" * 64) == (2**512 - 1) % L_MODULUS
    with pytest.raises(ValueError):
        FQ.from_bytes_wide(b"\x00" * 32)


def _random_ops(seed: int, n: int):
    """A seeded stream of transcript operations: labels and messages of
    random lengths (across the sponge's 166-byte rate), scalars, points
    and challenges of random widths."""
    rs = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        kind = rs.randint(5)
        label = bytes(rs.randint(0, 256, size=rs.randint(0, 20)).astype(
            np.uint8))
        if kind == 0:
            msg = bytes(rs.randint(0, 256, size=rs.randint(0, 400)).astype(
                np.uint8))
            ops.append(("append_message", label, msg))
        elif kind == 1:
            v = int.from_bytes(bytes(rs.randint(0, 256, size=40).astype(
                np.uint8)), "little")
            ops.append(("append_scalar", label, v))
        elif kind == 2:
            ops.append(("append_point", label, bytes(rs.randint(
                0, 256, size=32).astype(np.uint8))))
        elif kind == 3:
            ops.append(("challenge_bytes", label, int(rs.randint(1, 300))))
        else:
            ops.append(("challenge_scalar", label))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transcript_stream_equals_vpin_tpu(seed):
    plog, jlog = [], []
    port, ref = Transcript(b"proto", log=plog), JTranscript(b"proto", log=jlog)
    for op in _random_ops(seed, 60):
        name, *args = op
        assert getattr(port, name)(*args) == getattr(ref, name)(*args), op
    assert plog == jlog and len(plog) > 5


def test_random_tape_equals_vpin_tpu():
    for seed in (0, 11, L_MODULUS - 1):
        port, ref = RandomTape(b"proof", seed=seed), JRandomTape(b"proof",
                                                                 seed=seed)
        assert port.random_scalar(b"r") == ref.random_scalar(b"r")
        assert port.random_vector(b"poly_blinds", 17) == \
            ref.random_vector(b"poly_blinds", 17)


@pytest.mark.parametrize("seed", [3, 4])
def test_snapshot_equals_vpin_tpu_and_restores_mid_stream(seed):
    """After the same operations both packages' snapshots are the same
    tuple; a fresh transcript restored from it mid-stream gives the
    challenges that follow, as vpin_tpu's does."""
    ops = _random_ops(seed, 80)
    port, ref = Transcript(b"proto"), JTranscript(b"proto")
    for op in ops[:40]:
        name, *args = op
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
    snap = port.snapshot()
    assert snap == ref.snapshot()
    assert isinstance(snap[0], bytes) and len(snap[0]) == 200
    resumed = Transcript(b"other")
    resumed.restore(snap)
    for op in ops[40:]:
        name, *args = op
        want = getattr(ref, name)(*args)
        assert getattr(port, name)(*args) == want, op
        assert getattr(resumed, name)(*args) == want, op
    tape, jtape = RandomTape(b"proof", seed=seed), JRandomTape(b"proof",
                                                                seed=seed)
    tape.random_vector(b"blinds_poly", 3)
    jtape.random_vector(b"blinds_poly", 3)
    assert tape.snapshot() == jtape.snapshot()
    fresh = RandomTape(b"proof", seed=seed + 1)
    fresh.restore(tape.snapshot())
    assert fresh.random_vector(b"v", 5) == jtape.random_vector(b"v", 5)
