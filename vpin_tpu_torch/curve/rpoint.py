"""Single-point ristretto255 wrapper for the sigma-protocol layer.

Port of vpin_tpu/curve/rpoint.py.  RPoint is host-backed
(curve/host_ristretto.py): the nizk layer touches a handful of points per
Fiat-Shamir step, strictly serially.  ``pointe_from_host`` lifts host points
to a device batch with the Montgomery conversion done in host integers.
MSMs above HOST_MSM_MAX points go to the device's windowed tables
(curve/msm.py); the verifier never does (batch_verify.py).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..field import FP
from ..field import limbs as L
from . import host_ristretto as H
from .host_ristretto import HPoint, P
from .ristretto import RISTRETTO, PointE

#: MSMs at or below this many points run on the host; larger ones go to the
#: device's windowed-table kernels.  Read at call time, so tests can lower it.
HOST_MSM_MAX = 1024


class RPoint:
    __slots__ = ("h",)

    def __init__(self, h: HPoint):
        if not isinstance(h, HPoint):
            raise TypeError("RPoint wraps a host HPoint")
        self.h = h

    @staticmethod
    def identity() -> "RPoint":
        return RPoint(H.identity())

    @staticmethod
    def basepoint() -> "RPoint":
        return RPoint(H.basepoint())

    @staticmethod
    def decompress(b: bytes) -> "RPoint":
        return RPoint(H.decode(bytes(b)))

    @staticmethod
    def from_dev(p: PointE) -> "RPoint":
        """Device single point -> host."""
        x, y, z, t = (int(FP.from_mont(c)) for c in p)
        return RPoint(HPoint(x, y, z, t))

    def __add__(self, other: "RPoint") -> "RPoint":
        return RPoint(self.h + other.h)

    def __sub__(self, other: "RPoint") -> "RPoint":
        return RPoint(self.h - other.h)

    def __neg__(self) -> "RPoint":
        return RPoint(-self.h)

    def mul(self, k: int) -> "RPoint":
        return RPoint(self.h.mul(int(k)))

    __mul__ = mul
    __rmul__ = mul

    def compress(self) -> bytes:
        return self.h.encode()

    def __eq__(self, other) -> bool:
        return self.h.eq(other.h)

    def __hash__(self):
        return hash(self.compress())


def pointe_from_host(points: Sequence[HPoint], device=None) -> PointE:
    """Host points -> device PointE batch (n,); the Montgomery conversion
    runs in host integers, so no kernel is involved."""
    dev = resolve_device(device)
    coords = [[FP.R * (getattr(q, c) % P) % P for q in points]
              for c in ("x", "y", "z", "t")]
    return PointE(*(L.to_tensor(L.ints_to_limbs(
        np.asarray(v, dtype=object).reshape(len(points))), dev)
        for v in coords))


def msm_host(scalars: Sequence[int], points: Sequence[RPoint],
             device=None) -> RPoint:
    """sum_i scalars[i] * points[i] (reference Spartan/src/group.rs:103-122):
    host Straus/Pippenger at or below HOST_MSM_MAX points, the device's
    one-shot windowed table on ``device`` above."""
    if len(scalars) != len(points):
        raise ValueError("msm_host: as many scalars as points")
    if not points:
        return RPoint.identity()
    if len(points) <= HOST_MSM_MAX:
        return RPoint(H.msm(list(scalars), [q.h for q in points]))
    from .msm import host_digits, msm_oneshot
    dev = resolve_device(device)
    stack = pointe_from_host([q.h for q in points], dev)
    out = msm_oneshot(RISTRETTO, stack,
                      torch.as_tensor(host_digits(list(scalars)), device=dev))
    return RPoint.from_dev(out)


def decompress_many(encs: Sequence[bytes]) -> List[RPoint]:
    return [RPoint(H.decode(bytes(e))) for e in encs]


def compress_many(points: Sequence[RPoint]) -> List[bytes]:
    return [q.compress() for q in points]
