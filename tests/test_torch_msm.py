"""K4's MSM entries (vpin_tpu_torch/curve/cuda_edwards.py: ed_table and
ed_msm, under curve/msm.py) on the CPU, where the wrappers run their plain
PyTorch versions, against the addition chain they replace, vpin_tpu's table
MSM and host_ristretto.

Tolerance: exact.  The digit table is the same chain of additions on the
same operands as before, so its limbs are compared; the MSM's sums associate
differently from vpin_tpu's scans, so those are compared as compressed
ristretto encodings, which are unique per group element.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpin_tpu.curve import host_ristretto as JH
from vpin_tpu.curve.msm import FixedBaseMSM as JFixedBaseMSM
from vpin_tpu.curve.ristretto import RISTRETTO as JR
from vpin_tpu.curve.rpoint import pointe_from_host as jpointe_from_host
from vpin_tpu_torch import kernels
from vpin_tpu_torch.convert import pointe_from_jax
from vpin_tpu_torch.curve import cuda_edwards as CE
from vpin_tpu_torch.curve import host_ristretto as H
from vpin_tpu_torch.curve.msm import build_table, host_digits, msm_digits
from vpin_tpu_torch.curve.ristretto import RISTRETTO as R, PointE
from vpin_tpu_torch.curve.rpoint import pointe_from_host
from vpin_tpu_torch.field.prime_field import L_MODULUS

N_POINTS = 70


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def points():
    """70 host points (the identity first) and their digit table."""
    pts = [H.identity()] + [H.from_uniform_bytes(bytes([i, 7]) * 32)
                            for i in range(1, N_POINTS)]
    table = build_table(R, pointe_from_host(pts, "cpu"))
    return pts, table


def _encodings(out):
    return R.encode_bytes(PointE(*out))


def test_ed_table_plain_equals_the_addition_chain():
    """ed_table_plain is limb for limb the chain of group adds it replaces,
    row 0 the identity and row d = row d-1 + P, and vpin_tpu's table: with
    P padded by the identity to 8, as vpin_tpu pads 5 points, every limb of
    the two (256, 8) tables agrees."""
    pts = [H.from_uniform_bytes(bytes([i, 9]) * 32) for i in range(5)]
    P = pointe_from_host(pts, "cpu")
    P = PointE(*(torch.cat([c, i]) for c, i in zip(P, R.identity((3,), "cpu"))))
    rows = [R.identity((8,), "cpu")]
    for _ in range(255):
        rows.append(R.add(rows[-1], P))
    want = [torch.stack([r[c] for r in rows]) for c in range(4)]
    got = CE.ed_table_plain(R, tuple(P))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    jtab = JFixedBaseMSM(JR, jpointe_from_host(
        [JH.HPoint(q.x, q.y, q.z, q.t) for q in pts]))
    assert jtab.n_pad == 8
    jt = pointe_from_jax(jtab.table, "cpu")
    assert all(torch.equal(g, w) for g, w in zip(got, jt))
    enc = R.encode_bytes(PointE(*(c[:, 2] for c in got)))
    assert enc == [pts[2].mul(d).encode() for d in range(256)]


def test_ed_msm_plain_equals_vpin_tpu_and_host(points):
    """2 rows x 5 points (a table padded to 8 in vpin_tpu), digits 0 and 255
    included, against vpin_tpu's msm_digits and host_ristretto."""
    pts, table = points
    rng = random.Random(41)
    scalars = [[rng.randrange(L_MODULUS) for _ in range(5)] for _ in range(2)]
    digits = np.stack([host_digits(row) for row in scalars])
    digits[0, :, 3] = 0
    digits[1, :, 5] = 255
    digits[1, 2, :] = 255                    # 2^256 - 1, reduced by the group
    ks = [[int.from_bytes(bytes(d), "little") for d in row] for row in digits]
    got = CE.ed_msm_plain(R, tuple(table), torch.as_tensor(digits))
    jtab = JFixedBaseMSM(JR, jpointe_from_host(
        [JH.HPoint(q.x, q.y, q.z, q.t) for q in pts[:5]]))
    want = jtab.msm(jnp.asarray(digits.astype(np.int32)))
    enc = _encodings(got)
    assert jtab.n_pad == 8
    assert enc == JR.encode_bytes(want)
    assert enc == [H.msm(k, pts[:5]).encode() for k in ks]


@pytest.mark.parametrize("rows,n,chunk", [(3, 70, 32), (2, 37, 64),
                                          (1, 33, 32), (2, 1, 1024)],
                         ids=["3-chunks", "ragged-lanes", "one-spill",
                              "one-point"])
def test_ed_msm_plain_association_gives_the_group_sum(points, rows, n, chunk):
    """Chunks, lanes with and without a second point, the lane tree and the
    partials' fold all sum to the host MSM, for every row."""
    pts, table = points
    digits = np.random.RandomState(n + chunk).randint(
        0, 256, size=(rows, n, 32)).astype(np.uint8)
    ks = [[int.from_bytes(bytes(d), "little") for d in row] for row in digits]
    got = CE.ed_msm_plain(R, tuple(table), torch.as_tensor(digits), chunk)
    assert _encodings(got) == [H.msm(k, pts[:n]).encode() for k in ks]


def test_ed_msm_plain_of_nothing_is_the_identity(points):
    """Zero digits, and no points at all, give the identity."""
    _, table = points
    zero = CE.ed_msm_plain(R, tuple(table),
                           torch.zeros((2, 9, 32), dtype=torch.uint8))
    empty = CE.ed_msm_plain(R, tuple(table),
                            torch.zeros((1, 0, 32), dtype=torch.uint8))
    assert _encodings(zero) == [bytes(32)] * 2
    assert _encodings(empty) == [bytes(32)]


def test_cpu_wrappers_take_the_plain_versions(points):
    pts, table = points
    P = pointe_from_host(pts[:4], "cpu")
    digits = torch.as_tensor(host_digits([3, 0, 7, L_MODULUS - 1]))[None]
    before = dict(kernels.LAUNCHES)
    got = CE.ed_table(R, tuple(P))
    assert all(torch.equal(g, w)
               for g, w in zip(got, CE.ed_table_plain(R, tuple(P))))
    got = CE.ed_msm(R, tuple(table), digits)
    assert all(torch.equal(g, w) for g, w in zip(
        got, CE.ed_msm_plain(R, tuple(table), digits)))
    one = msm_digits(R, table, digits[0].long())
    assert R.encode_bytes(PointE(*(c[None] for c in one))) == \
        _encodings(got)
    assert kernels.LAUNCHES == before


def test_ed_msm_refuses_what_the_kernels_do_not_take(points):
    _, table = points
    ok = torch.zeros((1, 4, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):                 # not uint8
        CE.ed_msm(R, tuple(table), ok.long())
    with pytest.raises(ValueError):                 # wider than the table
        CE.ed_msm(R, tuple(table), torch.zeros((1, N_POINTS + 1, 32),
                                               dtype=torch.uint8))
    with pytest.raises(ValueError):                 # not a digit table
        CE.ed_msm(R, tuple(c[:8] for c in table), ok)
    with pytest.raises(ValueError):                 # not a flat batch
        CE.ed_table(R, tuple(c[:2] for c in table))
