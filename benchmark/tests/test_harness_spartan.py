"""The reference's witness commitments (benchmark/reference/spartan.py)
against the standards and against vpin_tpu_torch on the CPU: Keccak-f as
SHA3 against hashlib, ristretto255, the merlin random tape, the Pedersen
generators and the Hyrax rows of a 2-add witness."""

from __future__ import annotations

import hashlib
import random

import pytest

from benchmark.reference import spartan as S


def _sha3_256(msg: bytes) -> bytes:
    st, rate = bytearray(200), 136
    m = bytearray(msg) + b"\x06"
    m += bytes(-len(m) % rate)
    m[-1] |= 0x80
    for i in range(0, len(m), rate):
        for j in range(rate):
            st[j] ^= m[i + j]
        S.keccak_f1600(st)
    return bytes(st[:32])


@pytest.mark.parametrize("msg", [b"", b"abc", bytes(range(256)) * 2])
def test_keccak_is_sha3(msg):
    assert _sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_ristretto_constants_and_basepoint():
    P, D = S.PP, S.D
    assert S.SQRT_M1 ** 2 % P == P - 1
    assert S.SQRT_AD_MINUS_ONE ** 2 % P == (-D - 1) % P
    assert S.INVSQRT_A_MINUS_D ** 2 * (-1 - D) % P == 1
    assert S.ONE_MINUS_D_SQ == (1 - D * D) % P
    assert S.D_MINUS_ONE_SQ == (D - 1) ** 2 % P
    assert S.encode(S.basepoint()).hex() == (
        "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76")


def test_ristretto_against_the_port():
    from vpin_tpu_torch.curve import host_ristretto as H
    rng = random.Random(7)
    for _ in range(6):
        b = rng.randbytes(64)
        assert S.encode(S.from_uniform_bytes(b)) == \
            H.from_uniform_bytes(b).encode()
    pts = [S.from_uniform_bytes(rng.randbytes(64)) for _ in range(5)]
    ks = [rng.randrange(S.ELL) for _ in pts]
    want = H.msm(ks, [H.decode(S.encode(p)) for p in pts])
    got = S.msm(ks, [S.window_table(p) for p in pts])
    assert S.encode(got) == want.encode()


def test_tape_and_generators_against_the_port():
    from vpin_tpu_torch.nizk.sigma import dot_product_proof_gens
    from vpin_tpu_torch.transcript.merlin import RandomTape
    seed = 2 ** 63 + 12345
    tape = RandomTape(bytes([2]), seed=seed)
    want = [tape.random_vector(b"poly_blinds", 4) for _ in range(2)]
    assert S.tape_blinds(seed, [4, 4]) == want
    gens = dot_product_proof_gens(8, b"gens_r1cs_sat").gens_n
    G, h = S.generators(8, b"gens_r1cs_sat")
    assert [S.encode(g) for g in G] == [g.encode() for g in gens.Gh]
    assert S.encode(h) == gens.hh.encode()


def test_two_add_commitments_against_the_port():
    """The rows the port commits a 2-add witness to, with tape seed 99,
    are the reference's, and a witness moved by one changes them."""
    from vpin_tpu_torch.gadgets.point_addition import point_addition_gadget
    from vpin_tpu_torch.snark.cp_snark import SNARKGens, cp_commit_witness
    from benchmark.reference import e2
    a, b, c = (e2.mul_g(k) for k in (5, 11, 2 ** 200 + 3))
    args = ([a[0], b[0]], [a[1], b[1]], [b[0], c[0]], [b[1], c[1]], [0, 0])
    out = point_addition_gadget(*args, device="cpu")
    gens = SNARKGens(*out[5:])
    _, _, _, para, inp = cp_commit_witness(out[1], out[2], out[3], gens,
                                           tape_seed=99, device="cpu")
    ref = S.commitments("add", args, 99)
    assert ref == ([bytes(r) for r in para.C], [bytes(r) for r in inp.C])
    moved = ([args[0][0] + 1, args[0][1]],) + args[1:]
    assert S.commitments("add", moved, 99)[1] != ref[1]
    assert S.commitments("add", args, 100)[0] != ref[0]
