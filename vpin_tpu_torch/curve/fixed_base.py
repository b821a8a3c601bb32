"""Fixed-base scalar multiplication via windowed point tables.

Port of vpin_tpu/curve/fixed_base.py.  For a fixed base P (the generator G
and each public key h: every ElGamal encryption computes r*G, m*G and r*h),

    T[w][d] = d * 2^(8w) * P     (32 windows x 256 digits)

so s*P = sum_w T[w][digit_w(s)]: a gather and a 5-level tree of K2
additions per batch.  The table is built in 8 batched additions: the
multiples 2^(8w+k) * P come from the host's exact arithmetic (255 doublings),
and level k fills digits [2^k, 2^(k+1)) of every window at once.  The
reference built its first row by a 256-step chain; the points are the same,
their projective limbs need not be.
"""

from __future__ import annotations

import numpy as np
import torch

from .host_ec import HostPoint
from .weierstrass import PointW, cat_points

N_WINDOWS = 32
N_DIGITS = 256


def scalars_to_digits(scalars) -> np.ndarray:
    """Host ints in [0, 2^256) (any nesting) -> (..., 32) int32 base-256
    digits, least significant first."""
    arr = np.asarray(scalars, dtype=object)
    buf = b"".join(int(v).to_bytes(N_WINDOWS, "little") for v in arr.reshape(-1))
    digits = np.frombuffer(buf, dtype=np.uint8).astype(np.int32)
    return digits.reshape(arr.shape + (N_WINDOWS,))


class FixedBaseTable:
    """Windowed digit table for one base point, on one device."""

    def __init__(self, group, base: HostPoint, device=None):
        self.group = group
        steps = np.empty((N_WINDOWS, 8), dtype=object)    # 2^(8w+k) * base
        P = base
        for w in range(N_WINDOWS):
            for k in range(8):
                steps[w, k] = P
                P = P + P
        step_dev = group.from_affine_host(steps, device)   # (32, 8)
        table = group.identity((N_WINDOWS, 1), step_dev.device)
        for k in range(8):
            step = PointW(*(c[:, k:k + 1] for c in step_dev))
            table = cat_points([table, group.add(table, step)], dim=1)
        self.table = table                                 # (32, 256)

    def mul(self, digits) -> PointW:
        """digits: (..., 32) ints -> the points sum_w T[w][digits[..., w]]."""
        digits = np.asarray(digits)
        shape = digits.shape[:-1]
        dev = self.table.device
        idx = torch.as_tensor(digits.reshape(-1, N_WINDOWS), dtype=torch.int64,
                              device=dev)
        w = torch.arange(N_WINDOWS, device=dev)
        pts = PointW(*(c[w, idx] for c in self.table))    # (n, 32)
        k = N_WINDOWS
        while k > 1:
            half = k // 2
            pts = self.group.add(PointW(*(c[:, :half] for c in pts)),
                                 PointW(*(c[:, half:] for c in pts)))
            k = half
        return PointW(*(c[:, 0].reshape(shape + (c.shape[-1],)) for c in pts))

    def mul_ints(self, scalars) -> PointW:
        return self.mul(scalars_to_digits(scalars))
