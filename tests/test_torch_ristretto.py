"""The port's ristretto255 group (vpin_tpu_torch/curve: host_ristretto,
ristretto, cuda_edwards, rpoint) on the CPU, where the K4 wrapper runs
its plain PyTorch version, against RFC 9496 and vpin_tpu.

Tolerance: exact.  K4's plain version uses the reference's formula, so its
outputs are compared with RistrettoGroup._add_jnp and with ed_add_pallas
(interpret mode) in extended limbs, bit for bit; encodings are compared
as bytes.  The MSMs are held against vpin_tpu in test_torch_commit.py, the
ladder (K5) in test_torch_ladder.py.
"""

import random

import numpy as np
import pytest
import torch

from vpin_tpu.curve import host_ristretto as JH
from vpin_tpu.curve.pallas_edwards import ed_add_pallas
from vpin_tpu.curve.ristretto import RISTRETTO as JR
from vpin_tpu.curve.rpoint import pointe_from_host as jpointe_from_host
from vpin_tpu_torch import convert
from vpin_tpu_torch.curve import cuda_edwards
from vpin_tpu_torch.curve import host_ristretto as H
from vpin_tpu_torch.curve.ristretto import (
    D, INVSQRT_A_MINUS_D, ONE_MINUS_D_SQ, P, RISTRETTO as R,
    RISTRETTO_BASEPOINT_COMPRESSED, SQRT_AD_MINUS_ONE, SQRT_M1, PointE,
)
from vpin_tpu_torch.curve.rpoint import RPoint, pointe_from_host
from vpin_tpu_torch.field.prime_field import L_MODULUS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# RFC 9496 (as tests/test_ristretto.py)
# ----------------------------------------------------------------------

def test_rfc_constants():
    assert D == 37095705934669439343138083508754565189542113879843219016388785533085940283555
    assert SQRT_M1 == 19681161376707505956807079304988542015446066515923890162744021073123829784752
    assert ONE_MINUS_D_SQ == 1159843021668779879193775521855586647937357759715417654439879720876111806838
    assert SQRT_AD_MINUS_ONE == 25063068953384623474111414158702152701244531502492656460079210482610430750235
    assert INVSQRT_A_MINUS_D == 54469307008909316920995813868745141605393597292927456921205312896311721017578


def test_small_multiples_through_the_tensor_route():
    # RFC 9496 appendix A.1 (first few): 0, B, 2B, 3B by tensor adds
    known = [
        "0000000000000000000000000000000000000000000000000000000000000000",
        RISTRETTO_BASEPOINT_COMPRESSED.hex(),
        "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
        "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    ]
    B = R.basepoint((1,), "cpu")
    acc = [R.identity((1,), "cpu")]
    for _ in range(3):
        acc.append(R.add(acc[-1], B))
    multiples = PointE(*(torch.cat(c) for c in zip(*acc)))
    assert [e.hex() for e in R.encode_bytes(multiples)] == known
    assert [H.basepoint().mul(k).encode().hex() for k in range(4)] == known


def test_decode_roundtrip_and_group_law():
    B = RPoint.basepoint()
    twoB = B + B
    threeB = twoB + B
    assert RPoint.decompress(twoB.compress()) == B.mul(2)
    assert threeB == B.mul(3)
    assert (threeB - B) == twoB
    assert (B - B) == RPoint.identity()
    assert B.mul(L_MODULUS) == RPoint.identity()
    with pytest.raises(ValueError):
        RPoint.decompress(b"\x01" + b"\x00" * 31)   # odd => negative s
    with pytest.raises(ValueError):
        RPoint.decompress(b"\xff" * 32)             # non-canonical
    with pytest.raises(ValueError):
        R.decode_bytes([b"\xff" * 32], "cpu")


# ----------------------------------------------------------------------
# K4's plain version against vpin_tpu
# ----------------------------------------------------------------------

def _scaled(points, rng):
    """Each host point in a random extended representation (lX:lY:lZ:lT)."""
    out = []
    for q in points:
        lam = rng.randrange(1, P)
        out.append(H.HPoint(q.x * lam % P, q.y * lam % P, q.z * lam % P,
                            q.t * lam % P))
    return out


def _edge_and_random_pairs(n_random, seed):
    rng = random.Random(seed)
    pool = [H.basepoint().mul(rng.randrange(1, L_MODULUS)) for _ in range(8)]
    A, ID = pool[0], H.identity()
    lhs = [ID, A, A, ID] + [pool[rng.randrange(8)] for _ in range(n_random)]
    rhs = [A, A, -A, ID] + [pool[rng.randrange(8)] for _ in range(n_random)]
    chunks = [bytes([seed, i]) * 32 for i in range(4)]
    lhs += [H.from_uniform_bytes(c) for c in chunks[:2]]
    rhs += [H.from_uniform_bytes(c) for c in chunks[2:]]
    return _scaled(lhs, rng), _scaled(rhs, rng)


def _both(points):
    """Host points -> (port PointE, vpin_tpu PointE) with the same limbs:
    both lifts agree, and the limbs repack both ways."""
    jp = jpointe_from_host([JH.HPoint(q.x, q.y, q.z, q.t) for q in points])
    port = pointe_from_host(points, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(port, convert.pointe_from_jax(jp, "cpu")))
    assert all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(convert.pointe_to_jax(port), jp))
    return port, jp


def test_ed_add_plain_equals_add_jnp():
    lhs, rhs = _edge_and_random_pairs(26, 3)
    (Pp, JP), (Qp, JQ) = _both(lhs), _both(rhs)
    got = cuda_edwards.ed_add(R, tuple(Pp), tuple(Qp))       # CPU: plain
    want = JR._add_jnp(JP, JQ)
    for g, w in zip(got, want):
        assert np.array_equal(convert.tensor_to_jax(g), np.asarray(w))
    # and the group law on the host
    enc = R.encode_bytes(PointE(*got))
    assert enc == [(a + b).encode() for a, b in zip(lhs, rhs)]
    assert enc[2] == enc[3] == bytes(32)


def test_ed_add_plain_equals_pallas_interpret():
    lhs, rhs = _edge_and_random_pairs(122, 4)               # one 128 tile
    (Pp, JP), (Qp, JQ) = _both(lhs), _both(rhs)
    got = cuda_edwards.ed_add_plain(R, tuple(Pp), tuple(Qp))
    want = ed_add_pallas(JR, JP, JQ, interpret=True)
    for g, w in zip(got, want):
        assert np.array_equal(convert.tensor_to_jax(g), np.asarray(w))


def test_ed_add_broadcasts_like_the_kernel_wrapper():
    lhs, rhs = _edge_and_random_pairs(2, 5)
    Pp = pointe_from_host(lhs, "cpu")
    one = PointE(*(c[:1] for c in pointe_from_host(rhs, "cpu")))
    got = R.add(Pp, one)
    want = R.add(Pp, PointE(*(c.expand_as(p) for c, p in zip(one, Pp))))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ----------------------------------------------------------------------
# encodings against vpin_tpu
# ----------------------------------------------------------------------

def test_encode_decode_uniform_bytes_equal_vpin_tpu():
    chunks = [bytes([i, 7]) * 32 for i in range(4)]
    pts = R.from_uniform_bytes(chunks, "cpu")
    encs = R.encode_bytes(pts)
    assert encs == JR.encode_bytes(JR.from_uniform_bytes(chunks))
    assert encs == [JH.from_uniform_bytes(c).encode() for c in chunks]
    back = R.decode_bytes(encs, "cpu")
    jback = JR.decode_bytes(encs)
    for g, w in zip(back, jback):
        assert np.array_equal(convert.tensor_to_jax(g), np.asarray(w))
    assert bool(R.eq(back, pts).all())

