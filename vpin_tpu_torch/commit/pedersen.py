"""Pedersen and Hyrax commitments over ristretto255, host or device.

Port of vpin_tpu/commit/pedersen.py (reference Spartan/src/commitments.rs):
  * MultiCommitGens::new derives n + 1 generators from
    SHAKE256(label || compressed basepoint) through the one-way map, on the
    host (commitments.rs:20-38);
  * commit = MSM(scalars, G) + blind * h (commitments.rs:74-98);
  * the Hyrax row commit (DensePolynomial::commit_inner,
    dense_mlpoly.rs:160-191): one table MSM per row on the device, or host
    MSMs for small polynomials.
Commitments over at most rpoint.HOST_MSM_MAX points stay on the host.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Dict, List, Sequence, Tuple

import torch

from ..device import resolve_device
from ..field import FQ
from ..field import limbs as L
from ..curve import host_ristretto as H
from ..curve import rpoint
from ..curve.host_ristretto import HPoint, RISTRETTO_BASEPOINT_COMPRESSED
from ..curve.msm import FixedBaseMSM, host_digits, limbs_to_digits, msm_oneshot
from ..curve.ristretto import RISTRETTO, PointE
from ..curve.rpoint import RPoint, pointe_from_host

R = RISTRETTO


def digits_from_mont(scalars_mont: torch.Tensor) -> torch.Tensor:
    """Montgomery-form scalar limbs (..., 8) -> base-256 digits (..., 32)."""
    plain = FQ.mul(scalars_mont, L.to_tensor(L.int_to_limbs(1),
                                             scalars_mont.device))
    return limbs_to_digits(plain)


class MultiCommitGens:
    """n generators + blinding generator h.  Host points are primary; the
    device views (point batches, MSM digit tables) build lazily, once per
    device."""

    def __init__(self, n: int, Gh: List[HPoint], hh: HPoint):
        self.n = n
        self.Gh = Gh                    # host generators, len n
        self.hh = hh                    # host blinding generator
        self._views: Dict[Tuple[str, str], object] = {}

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def new(n: int, label: bytes) -> "MultiCommitGens":
        shake = hashlib.shake_256()
        shake.update(label)
        shake.update(RISTRETTO_BASEPOINT_COMPRESSED)
        stream = shake.digest(64 * (n + 1))
        pts = [H.from_uniform_bytes(stream[64 * i: 64 * (i + 1)])
               for i in range(n + 1)]
        return MultiCommitGens(n, pts[:n], pts[n])

    # -- device views ----------------------------------------------------

    def _view(self, name: str, device, make):
        key = (name, str(device))
        v = self._views.get(key)
        if v is None:
            v = make(device)
            self._views[key] = v
        return v

    def G_msm(self, device) -> FixedBaseMSM:
        return self._view("G_msm", device, lambda d: FixedBaseMSM(
            R, pointe_from_host(self.Gh, d)))

    def h_msm(self, device) -> FixedBaseMSM:
        return self._view("h_msm", device, lambda d: FixedBaseMSM(
            R, pointe_from_host([self.hh], d)))

    def Gh_msm(self, device) -> FixedBaseMSM:
        """Fused [G..., h] table: Hyrax rows commit in one MSM."""
        return self._view("Gh_msm", device, lambda d: FixedBaseMSM(
            R, pointe_from_host(self.Gh + [self.hh], d)))

    # -- host views --------------------------------------------------------

    def G_point(self, i: int) -> RPoint:
        return RPoint(self.Gh[i])

    @property
    def h_point(self) -> RPoint:
        return RPoint(self.hh)

    def split_at(self, mid: int) -> Tuple["MultiCommitGens", "MultiCommitGens"]:
        return (MultiCommitGens(mid, self.Gh[:mid], self.hh),
                MultiCommitGens(self.n - mid, self.Gh[mid:], self.hh))


def commit_scalar(x: int, blind: int, gens: MultiCommitGens) -> RPoint:
    """x * G[0] + blind * h for single host scalars."""
    if gens.n != 1:
        raise ValueError("commit_scalar takes one generator")
    return RPoint(H.msm([int(x), int(blind)], [gens.Gh[0], gens.hh]))


def commit_vec_ints(scalars: List[int], blind: int, gens: MultiCommitGens,
                    device=None) -> RPoint:
    """<scalars, G> + blind * h over host scalars: host MSM at or below
    HOST_MSM_MAX points, the device's cached tables on ``device`` above."""
    n = len(scalars)
    if gens.n != n:
        raise ValueError(f"commit_vec_ints: {n} scalars for {gens.n} gens")
    if n <= rpoint.HOST_MSM_MAX:
        return RPoint(H.msm([int(s) for s in scalars] + [int(blind)],
                            gens.Gh + [gens.hh]))
    dev = resolve_device(device)
    msm = gens.G_msm(dev).msm(torch.as_tensor(host_digits(scalars), device=dev))
    if blind % FQ.modulus:
        hb = gens.h_msm(dev).msm(torch.as_tensor(host_digits([blind]),
                                                 device=dev))
        msm = R.add(msm, hb)
    return RPoint.from_dev(msm)


def commit_vec_dev(scalars_mont: torch.Tensor, blind: int,
                   gens: MultiCommitGens) -> PointE:
    """MSM(scalars, G) + blind * h; scalars are a device FQ vector (n, 8)."""
    n = scalars_mont.shape[0]
    if gens.n != n:
        raise ValueError(f"commit_vec_dev: {n} scalars for {gens.n} gens")
    dev = scalars_mont.device
    msm = gens.G_msm(dev).msm(digits_from_mont(scalars_mont))
    if blind % FQ.modulus == 0:
        return msm
    hb = gens.h_msm(dev).msm(torch.as_tensor(host_digits([blind]), device=dev))
    return R.add(msm, hb)


def hyrax_commit_host(Z_ints: Sequence[int], blinds: List[int],
                      gens_n: MultiCommitGens) -> List[HPoint]:
    """Row commitments over host scalars (small witnesses)."""
    Lr = len(blinds)
    n = len(Z_ints)
    Rsz = n // Lr
    if Lr * Rsz != n or gens_n.n != Rsz:
        raise ValueError("hyrax_commit_host: shapes do not match the gens")
    pts = gens_n.Gh + [gens_n.hh]
    return [H.msm([int(v) for v in Z_ints[i * Rsz:(i + 1) * Rsz]]
                  + [int(blinds[i])], pts)
            for i in range(Lr)]


#: scalars whose digits hyrax_commit makes at a time, written into the one
#: (L, R + 1, 32) digit buffer the MSM reads: a chunk's plain limbs are 32 B
#: a scalar, 128 MB at 2^22, where SPARK's comb_ops reaches 2^27 scalars at
#: LeNet L3 (4.3 GB of limbs, and a copy for the blinds' column, unchunked)
_DIGIT_CHUNK_ELEMS = 1 << 22


def hyrax_commit(Z_mont: torch.Tensor, blinds: List[int],
                 gens_n: MultiCommitGens) -> PointE:
    """Row commitments of Z viewed as an (L, R) matrix: every row is one
    MSM through the fused [G..., h] table, all rows in one batch."""
    Lr = len(blinds)
    n = Z_mont.shape[0]
    Rsz = n // Lr
    if Lr * Rsz != n or gens_n.n != Rsz:
        raise ValueError("hyrax_commit: shapes do not match the gens")
    dev = Z_mont.device
    digits = torch.empty((Lr, Rsz + 1, 32), dtype=torch.uint8, device=dev)
    step = max(_DIGIT_CHUNK_ELEMS // Rsz, 1)
    for lo in range(0, Lr, step):
        hi = min(lo + step, Lr)
        digits[lo:hi, :Rsz] = digits_from_mont(
            Z_mont[lo * Rsz:hi * Rsz]).reshape(hi - lo, Rsz, 32)
    digits[:, Rsz] = torch.as_tensor(host_digits(blinds), device=dev)
    return gens_n.Gh_msm(dev).msm(digits)


def msm_points(scalars: List[int], points: PointE) -> PointE:
    """Host-scalar MSM over a device (n,) point batch (reference
    group.rs:103-122); one-shot windowed table."""
    return msm_oneshot(R, points, torch.as_tensor(host_digits(scalars),
                                                  device=points.device))
