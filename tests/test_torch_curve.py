"""Port curve E2 (vpin_tpu_torch on the CPU, where the K2 and K3 wrappers run
their plain PyTorch versions) against vpin_tpu's JAX group law.

Tolerance: exact.  K2 and K3 use the reference's formula and operation
order, so their outputs are compared in projective limbs, bit for bit.
Sums whose association differs from the reference (sum_points, the
fixed-base tables) are compared in affine form against vpin_tpu or the
exact host arithmetic of curve/host_ec.py.
"""

import random

import jax
import numpy as np
import pytest
import torch

from vpin_tpu.curve.fixed_base import scalars_to_digits as jax_digits
from vpin_tpu.curve.host_ec import E2_G_HOST, E2_ORDER, host_infinity
from vpin_tpu.curve.weierstrass import E2 as JE2, PointW as JPointW
from vpin_tpu.curve.weierstrass import scalars_to_bits as jax_bits
from vpin_tpu_torch import convert
from vpin_tpu_torch.curve import cuda_ec
from vpin_tpu_torch.curve import host_ec as port_host
from vpin_tpu_torch.curve.fixed_base import FixedBaseTable, scalars_to_digits
from vpin_tpu_torch.curve.weierstrass import (
    E2, PointW, bit_rows, pack_bits, scalars_to_bits, take,
)

RNG = random.Random(11)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_host_points(n):
    return [RNG.randrange(1, E2_ORDER) * E2_G_HOST for _ in range(n)]


def port(P):
    return convert.point_from_jax([np.asarray(c) for c in P], "cpu")


def assert_bit_equal(got: PointW, want) -> None:
    for g, w in zip(got, want):
        assert np.array_equal(convert.tensor_to_jax(g), np.asarray(w))


def host_tuples(pts):
    return [(p.inf, p.x, p.y) for p in np.asarray(pts, dtype=object).reshape(-1)]


G = E2_G_HOST
INF = host_infinity()
# the seven cases of tests/test_curve_e2.py: doubling, identity on either
# side and both, inverse pairs
SPECIAL = [(G, G), (G, INF), (INF, G), (INF, INF), (G, -G), (2 * G, 2 * G),
           (3 * G, -3 * G)]


@pytest.fixture(scope="module")
def jadd():
    return jax.jit(JE2._add_jnp)


@pytest.fixture(scope="module")
def pairs(jadd):
    """Affine and projective (random Z) point pairs as vpin_tpu arrays."""
    Ps = [p for p, _ in SPECIAL] + rand_host_points(9)
    Qs = [q for _, q in SPECIAL] + rand_host_points(9)
    dP = JE2.from_affine_host(Ps)
    dQ = JE2.from_affine_host(Qs)
    R = jadd(dP, dQ)                # projective outputs with Z != 1
    S = jadd(R, dQ)
    return Ps, Qs, dP, dQ, R, S


def test_e2_add_matches_jax_in_projective_limbs(pairs, jadd):
    Ps, Qs, dP, dQ, R, S = pairs
    for X, Y in [(dP, dQ), (R, dQ), (R, R), (dQ, R), (R, S), (S, S)]:
        got = E2.add(port(X), port(Y))
        assert_bit_equal(got, jadd(X, Y))
        assert_bit_equal(PointW(*cuda_ec.e2_add_plain(E2, tuple(port(X)),
                                                      tuple(port(Y)))),
                         jadd(X, Y))


def test_e2_add_special_cases_match_host(pairs):
    Ps, Qs, dP, dQ, _, _ = pairs
    out = E2.to_affine_host(E2.add(port(dP), port(dQ)))
    assert host_tuples(out) == host_tuples([p + q for p, q in zip(Ps, Qs)])


def test_e2_add_broadcasts(pairs):
    _, _, dP, dQ, _, _ = pairs
    P = port(dP)
    one = take(port(dQ), slice(0, 1))
    got = E2.add(P, one)
    want = E2.add(P, PointW(*(c.expand_as(P.x).clone() for c in one)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n_bits", [2, 128, 253])
def test_scalar_mul_matches_jax_in_projective_limbs(pairs, n_bits):
    """K3 against the reference's scan of ladder steps, with ladders of the
    zero scalar, all-ones and the group order, on the identity, on affine
    and on projective bases."""
    _, _, dP, _, R, _ = pairs
    base = [np.concatenate([np.asarray(a)[:8], np.asarray(b)[:8]])
            for a, b in zip(dP, R)]
    top = E2_ORDER if n_bits == 253 else (1 << n_bits) - 1
    ks = [0, 1, top, top - 1 if n_bits > 1 else 0, 2, 3]
    ks += [RNG.randrange(1 << n_bits) for _ in range(16 - len(ks))]
    bits = jax_bits(ks, n_bits)
    want = jax.jit(JE2.scalar_mul_bits)(JPointW(*base), bits)
    got = E2.scalar_mul_bits(port(base), bits)
    assert_bit_equal(got, want)


def test_scalar_mul_bit_row_broadcast():
    """Bits broadcast over trailing axes (rho over windows), leading axes
    (weights over windows) and a broken pattern (materialised) all equal
    one explicit row per point."""
    pts = E2.from_affine_host(np.asarray(rand_host_points(12) + [INF],
                                         dtype=object)[:12].reshape(4, 3),
                              "cpu")
    rows = np.random.RandomState(1).randint(0, 2, size=(4, 3, 9)).astype(np.uint32)

    def explicit(bits):
        full = np.broadcast_to(bits, (4, 3, 9)).copy()
        return E2.scalar_mul_bits(pts, full)

    for bits, want_layout in [(rows[:, :1, :], (3, 4)),     # (4, 1, 9)
                              (rows[:1, :, :], (1, 3)),     # (1, 3, 9)
                              (rows[0, :, :], (1, 3)),      # (3, 9)
                              (rows[:1, :1, :], (1, 1))]:   # one scalar
        inner, nrows, _ = bit_rows(bits, (4, 3))
        assert (inner, nrows) == want_layout
        got = E2.scalar_mul_bits(pts, bits)
        assert all(torch.equal(g, w) for g, w in zip(got, explicit(bits)))
    pts3 = PointW(*(c.reshape(2, 2, 3, 8) for c in pts))
    bits = rows.reshape(2, 2, 3, 9)[:, :1, :1, :]               # (2, 1, 1, 9)
    assert bit_rows(bits, (2, 2, 3))[:2] == (6, 2)
    sparse = rows.reshape(2, 2, 3, 9)[:, :1, :, :]              # (2, 1, 3, 9)
    assert bit_rows(sparse, (2, 2, 3))[:2] == (1, 12)            # materialised
    got = E2.scalar_mul_bits(pts3, sparse)
    full = np.broadcast_to(sparse, (2, 2, 3, 9)).copy()
    want = E2.scalar_mul_bits(pts3, full)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_scalar_mul_wrapper_checks_bits():
    P = tuple(E2.generator((3,), "cpu"))
    words = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_ec.e2_scalar_mul(E2, P, words, 33, 1, 3)       # too few words
    with pytest.raises(ValueError):
        cuda_ec.e2_scalar_mul(E2, P, words.long(), 8, 1, 3)
    with pytest.raises(ValueError):
        cuda_ec.e2_scalar_mul(E2, P, words, 8, 1, 2)        # rows mismatch


def test_bits_and_digits_match_jax():
    ks = [0, 1, 2**128 - 1, E2_ORDER - 1] + [RNG.randrange(E2_ORDER)
                                             for _ in range(8)]
    arr = np.asarray(ks, dtype=object).reshape(3, 4)
    assert np.array_equal(scalars_to_bits(arr, 253), jax_bits(arr, 253))
    assert np.array_equal(scalars_to_digits(arr), jax_digits(arr))
    small = [0, 1, 2, 3]
    assert np.array_equal(scalars_to_bits(small, 2), jax_bits(small, 2))
    with pytest.raises(ValueError):
        scalars_to_bits([4], 2)
    with pytest.raises(ValueError):
        scalars_to_bits([-1], 8)
    bits = scalars_to_bits(ks, 253)
    words = pack_bits(bits)
    assert words.shape == (len(ks), 8)
    for k, row in zip(ks, words):
        assert sum(int(w) << (32 * i) for i, w in enumerate(row)) == k


def test_sum_points_matches_jax_in_affine_form():
    Ps = rand_host_points(5) + [INF]
    dP = JE2.from_affine_host(Ps)
    want = JE2.to_affine_host(jax.jit(JE2.sum_points)(dP))
    got = E2.to_affine_host(E2.sum_points(port(dP)))
    assert host_tuples(got) == host_tuples(want)
    # along a later axis, against the host
    grid = np.asarray(rand_host_points(6), dtype=object).reshape(2, 3)
    out = E2.to_affine_host(E2.sum_points(E2.from_affine_host(grid, "cpu"),
                                          axis=1))
    assert host_tuples(out) == host_tuples([r[0] + r[1] + r[2] for r in grid])


def test_fixed_base_table_matches_host():
    h = RNG.randrange(1, E2_ORDER) * port_host.E2_G_HOST
    ss = [0, 1, 255, 256, 2**128 + 7, E2_ORDER - 1] + [
        RNG.randrange(E2_ORDER) for _ in range(4)]
    for base in (port_host.E2_G_HOST, h):
        table = FixedBaseTable(E2, base, "cpu")
        assert table.table.batch_shape == (32, 256)
        out = E2.to_affine_host(table.mul_ints(
            np.asarray(ss, dtype=object).reshape(2, 5)))
        assert out.shape == (2, 5)
        assert host_tuples(out) == host_tuples([s * base for s in ss])


def test_group_helpers_match_host():
    Ps = rand_host_points(3) + [INF]
    dP = E2.from_affine_host(Ps, "cpu")
    assert host_tuples(E2.to_affine_host(dP)) == host_tuples(Ps)
    assert host_tuples(E2.to_affine_host(E2.neg(dP))) == host_tuples(
        [-p for p in Ps])
    assert E2.is_infinity(dP).tolist() == [False, False, False, True]
    doubled = E2.double(dP)
    assert E2.eq(doubled, E2.add(dP, dP)).all()
    assert E2.eq(dP, E2.neg(dP)).tolist() == [False, False, False, True]
    mask = np.array([True, False, True, False])
    sel = E2.select(mask, dP, doubled)
    want = [p if m else p + p for p, m in zip(Ps, mask)]
    assert host_tuples(E2.to_affine_host(sel)) == host_tuples(want)
    gen = E2.generator((2,), "cpu")
    assert host_tuples(E2.to_affine_host(gen)) == host_tuples([G, G])
