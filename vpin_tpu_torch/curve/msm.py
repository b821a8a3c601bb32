"""Windowed-table multi-scalar multiplication (MSM) on ristretto255.

Port of vpin_tpu/curve/msm.py (single-device path).  Scalars split into
W = 32 windows of c = 8 bits; each base point gets a digit table
S[d][i] = d * P_i for d in [0, 256), so the MSM is, per window, a gather of
table entries and a sum over the points, then one Horner pass (8 doublings
per window) over the 32 window sums:

    sum_i a_i * P_i = sum_w 2^(8w) * ( sum_i S[digit_{w,i}][i] )

Both steps are kernel K4's MSM entries (curve/cuda_edwards.py): the table of
n points is one ``ed_table`` launch (255 chained additions per column) and
each MSM two ``ed_msm`` launches that read only the n columns the digits
cover.  The sums associate differently from the reference's scans, so the
projective limbs may differ while the group element, and so every encoding,
is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.prime_field import L_MODULUS
from ..parallel.ops import sharded_msm_digits
from . import cuda_edwards
from .ristretto import PointE, take

N_WINDOWS = cuda_edwards.MSM_WINDOWS  # 32 windows of 8 bits; l's top are 0


def limbs_to_digits(plain_limbs: torch.Tensor) -> torch.Tensor:
    """Plain (non-Montgomery) scalar limbs (..., 8) -> LSB-first base-256
    digits (..., 32) uint8."""
    w = plain_limbs.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 8, device=w.device)
    digits = ((w.unsqueeze(-1) >> shifts) & 0xFF).to(torch.uint8)
    return digits.reshape(plain_limbs.shape[:-1] + (N_WINDOWS,))


def host_digits(ints) -> np.ndarray:
    """Host ints -> (n, 32) uint8 digits (scalars reduced mod l)."""
    buf = b"".join((int(v) % L_MODULUS).to_bytes(32, "little") for v in ints)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(ints), 32).copy()


def build_table(group, P: PointE) -> PointE:
    """Digit table of a base batch P (n,): PointE (256, n) with
    table[d, i] = d * P_i (kernel K4's ``ed_table``)."""
    return PointE(*cuda_edwards.ed_table(group, tuple(P)))


def msm_digits(group, table: PointE, digits: torch.Tensor) -> PointE:
    """MSM through a prebuilt digit table (kernel K4's ``ed_msm``).

    digits: (rows, n, 32) or (n, 32) integer tensor of base-256 digits, with
    n at most the table's width; the first n columns are summed.  The rows
    split over the active mesh when one is set (parallel/ops.py).  Returns
    PointE (rows,), or one point for 2-D digits."""
    squeeze = digits.dim() == 2
    if squeeze:
        digits = digits.unsqueeze(0)
    if digits.shape[-1] != N_WINDOWS:
        raise ValueError(f"msm_digits: {digits.shape[-1]} windows, want "
                         f"{N_WINDOWS}")
    digits = digits.to(device=table.device, dtype=torch.uint8)
    out = sharded_msm_digits(group, table, digits)
    if out is None:
        out = PointE(*cuda_edwards.ed_msm(group, tuple(table), digits))
    return take(out, 0) if squeeze else out


class FixedBaseMSM:
    """Cached digit table for a fixed base-point vector (Pedersen gens)."""

    def __init__(self, group, P: PointE):
        self.group = group
        self.n = P.batch_shape[0]
        self.table = build_table(group, P)

    def msm(self, digits: torch.Tensor) -> PointE:
        return msm_digits(self.group, self.table, digits)


def msm_oneshot(group, P: PointE, digits: torch.Tensor) -> PointE:
    """One-shot MSM over fresh points (table built inline, not cached)."""
    return msm_digits(group, build_table(group, P), digits)
