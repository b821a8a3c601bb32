"""K5, the ristretto255 double-and-add ladder (vpin_tpu_torch/curve:
cuda_edwards.ed_ladder, RistrettoGroup.scalar_mul_bits and msm_bits), on the
CPU, where the K5 wrapper runs its plain PyTorch version, against vpin_tpu,
host_ristretto and the port's table MSM.

Tolerance: exact.  K5's plain version scans the reference's step, so its
outputs are compared with vpin_tpu's scalar_mul_bits and with
ed_ladder_step_pallas (interpret mode) in extended limbs, bit for bit; full
253-bit ladders and the ladder MSM (tests/test_msm.py's checks on the port)
are compared as encodings.

Slow tier: the interpret-mode comparison (the kernel's XLA compile).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpin_tpu.curve.pallas_edwards import ed_ladder_step_pallas
from vpin_tpu.curve.ristretto import RISTRETTO as JR
from vpin_tpu_torch.commit.pedersen import (
    MultiCommitGens, commit_vec_ints, hyrax_commit,
)
from vpin_tpu_torch.curve import cuda_edwards
from vpin_tpu_torch.curve import host_ristretto as H
from vpin_tpu_torch.curve.msm import host_digits, msm_oneshot
from vpin_tpu_torch.curve.ristretto import RISTRETTO as R, PointE
from vpin_tpu_torch.curve.rpoint import pointe_from_host
from vpin_tpu_torch.curve.weierstrass import pack_bits, scalars_to_bits
from vpin_tpu_torch import convert
from vpin_tpu_torch.field import FQ
from vpin_tpu_torch.field.prime_field import L_MODULUS

from test_torch_ristretto import _both, _edge_and_random_pairs


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
# K5's plain version (the whole ladder) against vpin_tpu
# ----------------------------------------------------------------------

def _ladder_inputs(n, n_bits, seed):
    """n scaled points (the identity first) and n rows of random bits, the
    first rows all clear, all set and the scalar 1."""
    lhs, _ = _edge_and_random_pairs(n - 6, seed)
    rows = np.random.RandomState(seed).randint(0, 2, size=(n, n_bits))
    rows[0] = 0
    rows[1] = 1
    rows[2] = 0
    rows[2, 0] = 1
    return lhs, rows.astype(np.uint32)


def test_ed_ladder_plain_equals_scalar_mul_bits():
    """Twelve bits over 16 points: the port's scalar_mul_bits (K5's plain
    version on the CPU) against vpin_tpu's scan of jnp steps, limb for
    limb, and the wrapper against the plain version on packed words."""
    pts, rows = _ladder_inputs(16, 12, 6)
    P, JP = _both(pts)
    got = R.scalar_mul_bits(P, rows)
    want = JR.scalar_mul_bits(JP, jnp.asarray(rows))
    for g, w in zip(got, want):
        assert np.array_equal(convert.tensor_to_jax(g), np.asarray(w))
    words = torch.from_numpy(pack_bits(rows).view(np.int32))
    plain = cuda_edwards.ed_ladder_plain(R, tuple(P), words, 12, 1, 16)
    assert all(torch.equal(a, b) for a, b in zip(plain, got))
    enc = R.encode_bytes(got)
    assert enc[0] == bytes(32) and enc[2] == R.encode_bytes(P)[2]


# XLA's compile of the interpreted kernel takes 130-210 s on one CPU thread
# (the first step; each further step about 2 s), whatever the batch: 8
# points already fill one 128-lane tile
@pytest.mark.slow
def test_ed_ladder_plain_equals_pallas_steps_interpret():
    """Three steps of ed_ladder_step_pallas (interpret mode) scanned from
    the identity, against the port's three-bit ladder."""
    pts, rows = _ladder_inputs(8, 3, 7)
    P, JP = _both(pts)
    zx = jnp.zeros_like(JP.x)
    one = zx + JR.F.R_dev
    acc, base = type(JP)(zx, one, one, jnp.zeros_like(JP.t)), JP
    for i in range(3):
        acc, base = ed_ladder_step_pallas(JR, acc, base,
                                          jnp.asarray(rows[:, i]),
                                          interpret=True)
    got = R.scalar_mul_bits(P, rows)
    for g, w in zip(got, acc):
        assert np.array_equal(convert.tensor_to_jax(g), np.asarray(w))


def test_scalar_mul_bits_full_width_equals_host():
    """253-bit ladders, one bit row broadcast over a (2, 3) batch and one
    row per point, as encodings against host_ristretto."""
    rng = random.Random(8)
    pts = [H.identity()] + [H.basepoint().mul(rng.randrange(1, L_MODULUS))
                            for _ in range(5)]
    ks = [0, 1, L_MODULUS - 1] + [rng.randrange(L_MODULUS) for _ in range(3)]
    P = pointe_from_host(pts, "cpu")
    got = R.scalar_mul_bits(P, scalars_to_bits(ks, 253))
    assert R.encode_bytes(got) == [p.mul(k).encode() for p, k in zip(pts, ks)]
    grid = PointE(*(c.reshape(2, 3, 8) for c in P))
    one_row = R.scalar_mul_bits(grid, scalars_to_bits([ks[5]], 253)[0])
    assert one_row.batch_shape == (2, 3)
    assert R.encode_bytes(one_row) == [p.mul(ks[5]).encode() for p in pts]


def _ladder_msm(scalars, points):
    return R.msm_bits(points, scalars_to_bits([s % L_MODULUS for s in scalars],
                                              253))


def _random_points(rng, n):
    ks = [rng.randrange(1, L_MODULUS) for _ in range(n)]
    return R.scalar_mul_bits(R.basepoint((n,), "cpu"), scalars_to_bits(ks, 253))


def test_oneshot_msm_matches_ladder():
    """tests/test_msm.py on the port: the table MSM (K4) equals the ladder
    MSM (K5) and host_ristretto."""
    rng = random.Random(7)
    pts = _random_points(rng, 8)
    scalars = [rng.randrange(L_MODULUS) for _ in range(6)] + [0, 1]
    want = _ladder_msm(scalars, pts)
    got = msm_oneshot(R, pts, torch.as_tensor(host_digits(scalars)))
    assert bool(R.eq(want, got))
    assert R.encode_bytes(want) == R.encode_bytes(got) == [H.msm(
        scalars, [H.decode(e) for e in R.encode_bytes(pts)]).encode()]


def _gens_stack(gens):
    """[G..., h] as one point batch."""
    return pointe_from_host(gens.Gh + [gens.hh], "cpu")


def test_fixed_base_commit_matches_ladder():
    rng = random.Random(9)
    gens = MultiCommitGens.new(8, b"test_msm_gens")
    scalars = [rng.randrange(L_MODULUS) for _ in range(8)]
    blind = rng.randrange(L_MODULUS)
    got = commit_vec_ints(scalars, blind, gens)
    want = _ladder_msm(scalars + [blind], _gens_stack(gens))
    assert R.encode_bytes(want) == [got.compress()]


def test_hyrax_rows_match_ladder():
    rng = random.Random(10)
    gens = MultiCommitGens.new(4, b"test_msm_hyrax")
    Lr, Rsz = 2, 4
    vals = [rng.randrange(L_MODULUS) for _ in range(Lr * Rsz)]
    blinds = [rng.randrange(L_MODULUS) for _ in range(Lr)]
    enc = R.encode_bytes(hyrax_commit(FQ.to_mont(vals, "cpu"), blinds, gens))
    for r in range(Lr):
        want = _ladder_msm(vals[r * Rsz:(r + 1) * Rsz] + [blinds[r]],
                           _gens_stack(gens))
        assert R.encode_bytes(want) == [enc[r]]
