"""The port's Pedersen and Hyrax commitments and windowed-table MSMs
(vpin_tpu_torch/commit, vpin_tpu_torch/curve/msm.py) on the CPU, where K4
and K1 run their plain PyTorch versions, against vpin_tpu.

Tolerance: exact, as compressed ristretto encodings: they are unique per
group element, and table sums may associate differently from the
reference's scans, so extended limbs are not compared here.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpin_tpu.commit.pedersen as jped
from vpin_tpu.commit.pedersen import MultiCommitGens as JGens
from vpin_tpu.curve import host_ristretto as JH
from vpin_tpu.curve.msm import FixedBaseMSM as JFixedBaseMSM
from vpin_tpu.curve.msm import host_digits as jhost_digits
from vpin_tpu.curve.ristretto import RISTRETTO as JR
from vpin_tpu.curve.rpoint import RPoint as JRPoint
from vpin_tpu.curve.rpoint import msm_host as jmsm_host
from vpin_tpu.curve.rpoint import pointe_from_host as jpointe_from_host
from vpin_tpu.field.prime_field import FQ as JFQ
from vpin_tpu_torch.commit import pedersen
from vpin_tpu_torch.commit.pedersen import (
    MultiCommitGens, commit_scalar, commit_vec_dev, commit_vec_ints,
    hyrax_commit, hyrax_commit_host,
)
from vpin_tpu_torch.curve import host_ristretto as H
from vpin_tpu_torch.curve import rpoint
from vpin_tpu_torch.curve.msm import FixedBaseMSM, host_digits, msm_digits
from vpin_tpu_torch.curve.ristretto import RISTRETTO as R, PointE
from vpin_tpu_torch.curve.rpoint import RPoint, pointe_from_host
from vpin_tpu_torch.field import FQ
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


def _jpoints(points):
    return jpointe_from_host([JH.HPoint(q.x, q.y, q.z, q.t) for q in points])


@pytest.mark.parametrize("n,label", [(1, b"g1"), (8, b"test-gens"),
                                     (17, b"gens_r1cs_sat")])
def test_gens_equal_vpin_tpu(n, label):
    gens, jgens = MultiCommitGens.new(n, label), JGens.new(n, label)
    assert [g.encode() for g in gens.Gh + [gens.hh]] == \
        [g.encode() for g in jgens.Gh + [jgens.hh]]
    a, b = gens.split_at(n // 2)
    assert a.n + b.n == n and a.hh is b.hh is gens.hh


def test_pedersen_homomorphism():
    gens = MultiCommitGens.new(4, b"test-gens")
    c1 = commit_vec_ints([1, 2, 3, 4], 7, gens)
    c2 = commit_vec_ints([5, 5, 5, 5], 3, gens)
    assert (c1 + c2) == commit_vec_ints([6, 7, 8, 9], 10, gens)
    g1 = MultiCommitGens.new(1, b"g1")
    assert (commit_scalar(11, 13, g1) + commit_scalar(2, 1, g1)) == \
        commit_scalar(13, 14, g1)


def test_hyrax_rows_equal_vpin_tpu():
    """A 2^10-entry polynomial as 32 rows of 32: the tensor route (one
    batched MSM through the fused [G, h] table), the host route and
    vpin_tpu's device route give the same row bytes."""
    rng = random.Random(5)
    gens, jgens = MultiCommitGens.new(32, b"hyrax"), JGens.new(32, b"hyrax")
    vals = [rng.randrange(L_MODULUS) for _ in range(1 << 10)]
    vals[:3] = [0, 1, L_MODULUS - 1]
    blinds = [rng.randrange(L_MODULUS) for _ in range(32)]
    rows = R.encode_bytes(hyrax_commit(FQ.to_mont(vals, "cpu"), blinds, gens))
    host = [p.encode() for p in hyrax_commit_host(vals, blinds, gens)]
    want = JR.encode_bytes(jped.hyrax_commit(JFQ.to_mont(vals), blinds, jgens))
    assert rows == host == want
    assert want == [p.encode() for p in
                    jped.hyrax_commit_host(vals, blinds, jgens)]


def test_commit_vec_on_both_sides_of_host_msm_max(monkeypatch):
    rng = random.Random(9)
    gens, jgens = MultiCommitGens.new(6, b"vec"), JGens.new(6, b"vec")
    scalars = [rng.randrange(L_MODULUS) for _ in range(6)]
    blind = rng.randrange(L_MODULUS)
    host = commit_vec_ints(scalars, blind, gens).compress()
    want = jped.commit_vec_ints(scalars, blind, jgens).compress()
    monkeypatch.setattr(rpoint, "HOST_MSM_MAX", 4)
    monkeypatch.setattr(jped, "HOST_MSM_MAX", 4)
    dev = commit_vec_ints(scalars, blind, gens, device="cpu").compress()
    jdev = jped.commit_vec_ints(scalars, blind, jgens).compress()
    tensor = R.encode_bytes(PointE(*(c[None] for c in commit_vec_dev(
        FQ.to_mont(scalars, "cpu"), blind, gens))))[0]
    assert host == dev == tensor == want == jdev


def test_fixed_base_msm_equals_vpin_tpu():
    """64 points x 4 rows through the cached digit table, against vpin_tpu's
    table MSM and the host MSM."""
    rng = random.Random(23)
    pts = [H.from_uniform_bytes(bytes([i, 3]) * 32) for i in range(64)]
    scalars = [[rng.randrange(L_MODULUS) for _ in range(64)] for _ in range(4)]
    scalars[0][:3] = [0, 1, L_MODULUS - 1]
    digits = np.stack([host_digits(row) for row in scalars])    # (4, 64, 32)
    got = FixedBaseMSM(R, pointe_from_host(pts, "cpu")).msm(
        torch.as_tensor(digits))
    want = JFixedBaseMSM(JR, _jpoints(pts)).msm(jnp.asarray(np.stack(
        [jhost_digits(row) for row in scalars])))
    enc = R.encode_bytes(got)
    assert enc == JR.encode_bytes(want)
    assert enc == [H.msm(row, pts).encode() for row in scalars]
    # 50 points in a 64-wide table: msm_digits pads the digits
    table = FixedBaseMSM(R, pointe_from_host(pts[:50], "cpu")).table
    one = msm_digits(R, table, torch.as_tensor(host_digits(scalars[1][:50])))
    assert R.encode_bytes(PointE(*(c[None] for c in one)))[0] == \
        H.msm(scalars[1][:50], pts[:50]).encode()


def test_msm_host_on_both_sides_of_host_msm_max(monkeypatch):
    rng = random.Random(29)
    pts = [H.basepoint().mul(rng.randrange(1, L_MODULUS)) for _ in range(12)]
    scalars = [rng.randrange(L_MODULUS) for _ in range(12)]
    want = jmsm_host(scalars, [JRPoint(JH.HPoint(q.x, q.y, q.z, q.t))
                               for q in pts]).compress()
    host = rpoint.msm_host(scalars, [RPoint(q) for q in pts])
    monkeypatch.setattr(rpoint, "HOST_MSM_MAX", 4)
    dev = rpoint.msm_host(scalars, [RPoint(q) for q in pts], device="cpu")
    oneshot = pedersen.msm_points(scalars, pointe_from_host(pts, "cpu"))
    assert host.compress() == dev.compress() == want == \
        R.encode_bytes(PointE(*(c[None] for c in oneshot)))[0]
