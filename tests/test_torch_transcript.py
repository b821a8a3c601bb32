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


# ----------------------------------------------------------------------
# the C core (csrc/keccak.c) against the plain version
# ----------------------------------------------------------------------

# lengths on both sides of the 166-byte rate and of its multiples
_RATE_EDGES = [0, 1, 2, 164, 165, 166, 167, 331, 332, 333, 500]


def _strobe_ops(seed: int, n: int):
    """A seeded stream of STROBE operations: meta_ad, ad, prf and key, some
    continued (``more``) with the same flags, of lengths across the rate."""
    rs = np.random.RandomState(seed)
    ops, last = [], None
    for _ in range(n):
        name = ("meta_ad", "ad", "prf", "key")[rs.randint(4)]
        more = last == name and rs.randint(3) == 0
        if rs.randint(3) == 0:
            size = _RATE_EDGES[rs.randint(len(_RATE_EDGES))]
        else:
            size = int(rs.randint(0, 400))
        arg = size if name == "prf" else bytes(
            rs.randint(0, 256, size=size).astype(np.uint8))
        ops.append((name, arg, more))
        last = name
    return ops


def _run(strobe, ops):
    return [getattr(strobe, name)(arg, more) for name, arg, more in ops]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_c_core_equals_the_plain_version(seed):
    from vpin_tpu_torch.transcript import Strobe128
    ops = _strobe_ops(seed, 120)
    c, plain = Strobe128(b"proto"), Strobe128(b"proto", native=False)
    assert c._lib is not None and plain._lib is None
    assert _run(c, ops) == _run(plain, ops)
    assert c.snapshot() == plain.snapshot()
    # a default transcript runs on the C core
    assert Transcript(b"t").strobe._lib is not None


@pytest.mark.parametrize("seed", [5, 6])
def test_c_core_snapshot_and_restore_mid_stream(seed):
    """A snapshot restored into the same sponge, into a fresh one and into a
    plain one continues alike: restore writes the C core's buffer in place."""
    from vpin_tpu_torch.transcript import Strobe128
    ops = _strobe_ops(seed, 80)
    c = Strobe128(b"proto")
    _run(c, ops[:40])
    snap = c.snapshot()
    want = _run(Strobe128(b"proto", native=False), ops)[40:]
    assert _run(c, ops[40:]) == want
    c.restore(snap)                      # the same object, its view intact
    assert c.snapshot() == snap
    assert _run(c, ops[40:]) == want
    for other in (Strobe128(b"other"), Strobe128(b"other", native=False)):
        other.restore(snap)
        assert _run(other, ops[40:]) == want
    with pytest.raises(ValueError):
        c.restore((snap[0][:199],) + snap[1:])


def test_c_core_build_failure_raises(tmp_path, monkeypatch):
    from vpin_tpu_torch.transcript import Strobe128, _native
    bad = tmp_path / "keccak.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="gcc exit"):
        Strobe128(b"proto")
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="gcc not found"):
        Strobe128(b"proto")
    assert not list((tmp_path / "build").glob("*.so"))
    # the plain version needs no build
    assert Strobe128(b"proto", native=False).prf(8, False) == \
        Strobe128(b"proto", native=False).prf(8, False)
