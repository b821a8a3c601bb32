"""Windowed-table multi-scalar multiplication (MSM) on ristretto255.

Port of vpin_tpu/curve/msm.py (single-device path).  Scalars split into
W = 32 windows of c = 8 bits; each base point gets a digit table
S[d][i] = d * P_i for d in [0, 256), so the MSM is, per window, a gather of
table entries and a halving-tree sum over the points, then one Horner pass
(8 doublings per window) over the 32 window sums:

    sum_i a_i * P_i = sum_w 2^(8w) * ( sum_i S[digit_{w,i}][i] )

Every group add is kernel K4.  One FixedBaseMSM over n points costs 255
serial table adds of width n (once per base vector), and per MSM
32 x log2(n) fold levels plus 32 x 9 Horner adds.  The sums may associate
differently from the reference's strided scan, so the projective limbs may
differ while the group element, and so every encoding, is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.prime_field import L_MODULUS
from .ristretto import PointE, cat_points, take

WINDOW_BITS = 8                      # c
N_WINDOWS = 32                       # ceil(256 / 8); top windows of l are 0
N_BUCKETS = 1 << WINDOW_BITS


def limbs_to_digits(plain_limbs: torch.Tensor) -> torch.Tensor:
    """Plain (non-Montgomery) scalar limbs (..., 8) -> LSB-first base-256
    digits (..., 32) int64."""
    w = plain_limbs.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, 8, device=w.device)
    digits = (w.unsqueeze(-1) >> shifts) & 0xFF
    return digits.reshape(plain_limbs.shape[:-1] + (N_WINDOWS,))


def host_digits(ints) -> np.ndarray:
    """Host ints -> (n, 32) int64 digits (scalars reduced mod l)."""
    buf = b"".join((int(v) % L_MODULUS).to_bytes(32, "little") for v in ints)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(ints), 32).astype(
        np.int64)


def build_table(group, P: PointE, n_pad: int = None) -> PointE:
    """Digit table of a base batch P (n,): PointE (256, n_pad) with
    table[d, i] = d * P_i; columns past n are the identity.  A serial chain
    of 255 adds of width n_pad."""
    n = P.batch_shape[0]
    n_pad = n_pad or n
    if n_pad != n:
        P = cat_points([P, group.identity((n_pad - n,), P.device)])
    rows = [group.identity((n_pad,), P.device)]
    for _ in range(N_BUCKETS - 1):
        rows.append(group.add(rows[-1], P))
    return PointE(*(torch.stack([r[i] for r in rows]) for i in range(4)))


def msm_digits(group, table: PointE, digits: torch.Tensor) -> PointE:
    """MSM through a prebuilt digit table.

    digits: (rows, n, 32) or (n, 32) integer tensor on the table's device;
    n is padded up to the table width with zero digits (digit 0 picks the
    identity row).  Returns PointE (rows,), or one point for 2-D digits."""
    squeeze = digits.dim() == 2
    if squeeze:
        digits = digits.unsqueeze(0)
    rows, n, W = digits.shape
    if W != N_WINDOWS:
        raise ValueError(f"msm_digits: {W} windows, want {N_WINDOWS}")
    n_pad = table.batch_shape[1]
    digits = digits.to(device=table.device, dtype=torch.int64)
    if n != n_pad:
        digits = torch.nn.functional.pad(digits, (0, 0, 0, n_pad - n))
    col = torch.arange(n_pad, device=table.device)
    # one window sum per window: gather (rows, n_pad), fold over the points
    Qw = [group.sum_points(take(table, (digits[..., w], col)), axis=1)
          for w in range(N_WINDOWS)]
    # Horner over the windows, MSB first: acc = 2^c * acc + Q_w
    acc = group.identity((rows,), table.device)
    for q in reversed(Qw):
        for _ in range(WINDOW_BITS):
            acc = group.add(acc, acc)
        acc = group.add(acc, q)
    return take(acc, 0) if squeeze else acc


def _pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


class FixedBaseMSM:
    """Cached digit table for a fixed base-point vector (Pedersen gens)."""

    def __init__(self, group, P: PointE):
        self.group = group
        self.n = P.batch_shape[0]
        self.n_pad = _pow2(max(self.n, 1))
        self.table = build_table(group, P, self.n_pad)

    def msm(self, digits: torch.Tensor) -> PointE:
        return msm_digits(self.group, self.table, digits)


def msm_oneshot(group, P: PointE, digits: torch.Tensor) -> PointE:
    """One-shot MSM over fresh points (table built inline, not cached)."""
    n = P.batch_shape[0]
    return msm_digits(group, build_table(group, P, _pow2(max(n, 1))), digits)
