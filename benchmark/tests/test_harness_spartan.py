"""The reference's witness commitments (benchmark/reference/spartan.py)
against the standards and against vpin_tpu_torch on the CPU: Keccak-f as
SHA3 against hashlib, ristretto255, the merlin random tape, the Pedersen
generators, the Hyrax rows of a 2-add and a 2-mult witness through the
rows' random linear combination, RFC 9496 DECODE, and the instances."""

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


def _port_rows(gadget_out, tape_seed=99):
    """The rows (para, input) the port commits a gadget's witness to."""
    from vpin_tpu_torch.snark.cp_snark import SNARKGens, cp_commit_witness
    gens = SNARKGens(*gadget_out[5:])
    _, _, _, para, inp = cp_commit_witness(
        gadget_out[1], gadget_out[2], gadget_out[3], gens,
        tape_seed=tape_seed, device="cpu")
    return [bytes(r) for r in para.C], [bytes(r) for r in inp.C]


def _two_adds():
    from benchmark.reference import e2
    a, b, c = (e2.mul_g(k) for k in (5, 11, 2 ** 200 + 3))
    return ([a[0], b[0]], [a[1], b[1]], [b[0], c[0]], [b[1], c[1]], [0, 0])


@pytest.fixture(scope="module")
def two_adds():
    """A 2-add witness, the port's gadget of it and its rows at tape seed
    99."""
    from vpin_tpu_torch.gadgets.point_addition import point_addition_gadget
    args = _two_adds()
    out = point_addition_gadget(*args, device="cpu")
    return args, out, _port_rows(out)


def test_two_add_commitments_against_the_port(two_adds):
    """The rows the port commits a 2-add witness to, with tape seed 99,
    are the reference's, and a witness moved by one or other blinds are
    at fault."""
    args, _, (para, inp) = two_adds
    assert not S.rows_at_fault("add", args, 99, para, inp, 1)
    moved = ([args[0][0] + 1, args[0][1]],) + args[1:]
    assert S.rows_at_fault("add", moved, 99, para, inp, 1)
    assert S.rows_at_fault("add", args, 100, para, inp, 1)


def test_decode_inverts_encode_and_refuses_the_rest():
    """RFC 9496 DECODE: every encoding decodes to a point that encodes to
    it again; a value at or above p, a negative s and a non-square are
    refused."""
    rng = random.Random(11)
    for _ in range(6):
        b = S.encode(S.from_uniform_bytes(rng.randbytes(64)))
        assert S.encode(S.decode(b)) == b
    assert S.decode(S.encode(S.ZERO)) is not None
    assert S.decode(S.PP.to_bytes(32, "little")) is None
    assert S.decode((1).to_bytes(32, "little")) is None       # negative
    assert S.decode(bytes(31)) is None
    small = [S.decode(s.to_bytes(32, "little")) for s in range(2, 40, 2)]
    assert None in small                                        # no point
    for s, p in zip(range(2, 40, 2), small):
        assert p is None or S.encode(p) == s.to_bytes(32, "little")


@pytest.fixture(scope="module")
def two_mults():
    """A 2-mult, 128-bit witness and the port's gadget of it (~2 min of
    the plain witness scan on one CPU thread)."""
    from vpin_tpu_torch.gadgets.point_mult import point_mult_gadget
    from benchmark.reference import e2
    pts = [e2.mul_g(k) for k in (7, 2 ** 100 + 5)]
    args = ([2 ** 127 + 12345, 3 ** 70], [p[0] for p in pts],
            [p[1] for p in pts])
    return args, point_mult_gadget(*args, device="cpu")


def test_mult_shares_equal_the_port(two_mults):
    """reference/gadgets/mult.py's shares are the port's vars_para and
    vars_input, value for value, with one public input."""
    from benchmark.reference.gadgets import mult
    args, out = two_mults
    para, inp, num_inputs = mult.shares(args)
    assert [int(v) for v in out[1]] == para
    assert [int(v) for v in out[2]] == inp
    assert num_inputs == out[7] == 1
    assert len(inp) == 2 * (27 * 128 + 10) + 1


def test_two_mult_commitments_against_the_port(two_mults):
    """The rows the port commits a 2-mult witness to, with tape seed 99,
    are the reference's; a scalar moved by one is at fault."""
    args, out = two_mults
    para, inp = _port_rows(out)
    assert not S.rows_at_fault("mult", args, 99, para, inp, 2)
    moved = ([args[0][0] + 1] + args[0][1:],) + args[1:]
    assert S.rows_at_fault("mult", moved, 99, para, inp, 2)


def test_the_combination_check_catches_one_moved_byte_or_blind(two_adds):
    """rows_combine passes the port's rows of a 2-add witness and fails one
    byte moved in one row (a string that decodes to another point, or to
    none), another row's point in its place, a row left out, and one moved
    blind."""
    args, _, (para, inp) = two_adds
    (share_para, share_inp), rows, G, h = S._witness("add", args, 99)
    rng = random.Random(5)
    coeffs = [rng.getrandbits(128) for _ in range(rows)]
    values, blinds = share_inp
    assert S.rows_combine(values, blinds, inp, coeffs, G, h)
    assert S.rows_combine(*share_para, para, coeffs, G, h)
    for pos in (0, 31):
        for step in (2, 4):
            moved = list(inp)
            row = bytearray(moved[1])
            row[pos] = (row[pos] + step) % 256
            moved[1] = bytes(row)
            assert not S.rows_combine(values, blinds, moved, coeffs, G, h)
            assert S.rows_at_fault("add", args, 99, para, moved, 3)
    swapped = [inp[1], inp[0]] + list(inp[2:])
    assert not S.rows_combine(values, blinds, swapped, coeffs, G, h)
    assert not S.rows_combine(values, blinds, inp[:-1], coeffs, G, h)
    moved_blind = [blinds[0] + 1] + list(blinds[1:])
    assert not S.rows_combine(values, moved_blind, inp, coeffs, G, h)


def _port_instance(gadget, count, weaken=False):
    """The port's instance of ``count`` operations, as the driver catches
    it at cp_snark_verify; ``weaken``: its last constraint replaced by a
    copy of the one before (the witness still satisfies it)."""
    from vpin_tpu_torch.gadgets import point_addition, point_mult
    from vpin_tpu_torch.snark.r1cs import R1CSInstance
    mod = point_addition if gadget == "add" else point_mult
    A, B, C, nc, nv, ni = mod.build_matrices(count)
    mats = [A, B, C]
    if weaken:
        mats = [weakened(m, nc) for m in mats]
    inst = R1CSInstance(nc, nv, ni, *mats, device="cpu")
    return (inst.num_cons, inst.num_vars, inst.num_inputs,
            tuple((m.rows, m.cols, m.codes, m.codebook)
                  for m in (inst.A, inst.B, inst.C)))


def weakened(mat, num_cons):
    """An (rows, cols, vals) matrix with its last row replaced by a copy
    of the row before."""
    import numpy as np
    rows, cols, vals = (np.asarray(x) for x in mat)
    keep, prev = rows != num_cons - 1, rows == num_cons - 2
    return (np.concatenate([rows[keep], np.full(int(prev.sum()),
                                                num_cons - 1)]),
            np.concatenate([cols[keep], cols[prev]]),
            np.concatenate([vals[keep], vals[prev]]))


@pytest.mark.parametrize("gadget,count", [("add", 2), ("add", 16),
                                          ("mult", 2), ("mult", 18)])
def test_instance_equals_the_port(gadget, count):
    """reference/gadgets' circuits, padded as Spartan pads them, are the
    port's instances entry for entry, at the tests' and the cells' sizes;
    a constraint replaced by a copy of another is at fault."""
    from benchmark.drivers.prove import instance_at_fault
    assert not instance_at_fault(gadget, count,
                                 _port_instance(gadget, count))
    assert instance_at_fault(gadget, count,
                             _port_instance(gadget, count, weaken=True))


@pytest.mark.parametrize("gadget", ["add", "mult"])
def test_circuits_have_the_configurations_sizes(bench, gadget):
    """The reference's circuit at conv3's counts has the sizes conv3.json
    states: num_cons, num_vars, num_inputs, and nnz (the fullest of A, B,
    C)."""
    from benchmark import cells
    p = cells.config(bench, "conv3")["proofs"][gadget]
    rows, num_vars, num_inputs = S.layout(gadget).constraints(p["count"])
    nnz = max(sum(len(r[side]) for r in rows) for side in range(3))
    assert (len(rows), num_vars, num_inputs, nnz) == (
        p["r1cs"]["num_cons"], p["r1cs"]["num_vars"],
        p["r1cs"]["num_inputs"], p["r1cs"]["nnz"])
