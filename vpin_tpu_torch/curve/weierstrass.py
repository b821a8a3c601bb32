"""Batched short-Weierstrass group ops on curve E2, on int32 limb tensors.

Port of vpin_tpu/curve/weierstrass.py with curve/padded.py folded in: the
methods take any batch shape and flatten it for the kernels themselves (the
reference padded batches to powers of two only to bound XLA compiles).
Addition is kernel K2 and scalar multiplication kernel K3
(curve/cuda_ec.py); points are projective (X : Y : Z), infinity = (0 : 1 : 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..field import FQ, PrimeField
from ..field.limbs import N_LIMBS, to_tensor, widen
from . import cuda_ec
from .host_ec import E2_A, E2_B, E2_GX, E2_GY, E2_HOST, E2_ORDER, HostPoint


class PointW(NamedTuple):
    """A batch of projective points; each leaf (..., 8) int32 limbs."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.x.device


def take(P: PointW, idx) -> PointW:
    """P indexed on its batch axes."""
    return PointW(*(c[idx] for c in P))


def cat_points(points, dim: int = 0) -> PointW:
    return PointW(*(torch.cat([p[i] for p in points], dim) for i in range(3)))


class WeierstrassCurve:
    """y^2 = x^3 + a x + b over a PrimeField."""

    def __init__(self, field: PrimeField, a: int, b: int, gx: int, gy: int,
                 order: int):
        self.F = field
        self.a_int, self.b_int = a, b
        self.order = order
        self.A = field.mont_limbs_np(a)
        self.B3 = field.mont_limbs_np(3 * b % field.modulus)
        self.gx_int, self.gy_int = gx, gy
        # CurveConsts of csrc/e2.cuh: FieldConsts, a[8], b3[8]
        self.kernel_consts = kernels.consts_array(
            [*field.kernel_words, *self.A, *self.B3])
        self._ab3 = {}

    def device_ab3(self, device):
        """(a, 3b) as int64 working limbs on ``device``."""
        key = str(device)
        if key not in self._ab3:
            self._ab3[key] = (widen(to_tensor(self.A, device)),
                              widen(to_tensor(self.B3, device)))
        return self._ab3[key]

    # -- constructors ---------------------------------------------------

    def infinity(self, shape=(), device=None) -> PointW:
        F = self.F
        return PointW(F.zeros(shape, device), F.ones(shape, device),
                      F.zeros(shape, device))

    identity = infinity

    def generator(self, shape=(), device=None) -> PointW:
        F = self.F
        dev = resolve_device(device)
        full = tuple(shape) + (N_LIMBS,)
        gx = to_tensor(F.mont_limbs_np(self.gx_int), dev).expand(full).clone()
        gy = to_tensor(F.mont_limbs_np(self.gy_int), dev).expand(full).clone()
        return PointW(gx, gy, F.ones(shape, dev))

    def from_affine_host(self, pts, device=None) -> PointW:
        """Host array (any nesting) of affine points with ``x``, ``y`` and
        ``inf`` (HostPoint) -> device batch."""
        arr = np.asarray(pts, dtype=object)
        shape = arr.shape
        xs, ys, infs = [], [], []
        for P in arr.reshape(-1):
            xs.append(0 if P.inf else P.x)
            ys.append(1 if P.inf else P.y)
            infs.append(bool(P.inf))
        dev = resolve_device(device)
        F = self.F
        X = F.to_mont(xs, dev).reshape(shape + (N_LIMBS,))
        Y = F.to_mont(ys, dev).reshape(shape + (N_LIMBS,))
        inf = torch.as_tensor(np.asarray(infs, dtype=bool).reshape(shape),
                              device=dev)
        Z = F.select(inf, F.zeros(shape, dev), F.ones(shape, dev))
        return PointW(X, Y, Z)

    def to_affine_host(self, P: PointW) -> np.ndarray:
        """Device batch -> numpy object array of HostPoint."""
        x, y, inf = self.to_affine(P)
        xs = self.F.from_mont(x).reshape(-1)
        ys = self.F.from_mont(y).reshape(-1)
        infs = inf.cpu().numpy().reshape(-1)
        out = np.empty(xs.shape, dtype=object)
        for i in range(xs.shape[0]):
            out[i] = HostPoint(E2_HOST, int(xs[i]), int(ys[i]), bool(infs[i]))
        return out.reshape(P.batch_shape)

    # -- group law ------------------------------------------------------

    def add(self, P: PointW, Q: PointW) -> PointW:
        """Complete projective addition (RCB15 Alg. 1): kernel K2."""
        return PointW(*cuda_ec.e2_add(self, tuple(P), tuple(Q)))

    def double(self, P: PointW) -> PointW:
        return self.add(P, P)

    def neg(self, P: PointW) -> PointW:
        return PointW(P.x, self.F.neg(P.y), P.z)

    def select(self, mask, P: PointW, Q: PointW) -> PointW:
        F = self.F
        return PointW(F.select(mask, P.x, Q.x), F.select(mask, P.y, Q.y),
                      F.select(mask, P.z, Q.z))

    def is_infinity(self, P: PointW):
        return self.F.is_zero(P.z)

    def eq(self, P: PointW, Q: PointW):
        """Projective equality: X1Z2 == X2Z1 and Y1Z2 == Y2Z1, with the
        points at infinity equal only to each other."""
        F = self.F
        Pinf, Qinf = self.is_infinity(P), self.is_infinity(Q)
        ex = F.eq(F.mul(P.x, Q.z), F.mul(Q.x, P.z))
        ey = F.eq(F.mul(P.y, Q.z), F.mul(Q.y, P.z))
        return torch.where(Pinf & Qinf, True,
                           torch.where(Pinf ^ Qinf, False, ex & ey))

    def to_affine(self, P: PointW):
        """-> (x, y, inf_mask); x, y in Montgomery form, (0, 0) at infinity."""
        F = self.F
        inf = self.is_infinity(P)
        zinv = F.inv(P.z)                 # inv(0) = 0
        return F.mul(P.x, zinv), F.mul(P.y, zinv), inf

    # -- scalar multiplication -------------------------------------------

    def scalar_mul_bits(self, P: PointW, bits) -> PointW:
        """[k]P where ``bits`` is a host array (..., n_bits) of LSB-first
        0/1 bits whose batch shape broadcasts to P's: kernel K3, the whole
        ladder in one launch.  A bits array that is broadcast along leading
        or trailing axes (rho_bits[:, None, :] against (M, f*f) windows) is
        passed once, not materialised."""
        bits = np.asarray(bits)
        n_bits = bits.shape[-1]
        shape = tuple(np.broadcast_shapes(P.batch_shape, bits.shape[:-1]))
        n = int(np.prod(shape, dtype=np.int64))
        inner, nrows, rows = bit_rows(bits, shape)
        words = to_tensor(pack_bits(rows), P.device)
        flat = tuple(c.expand(shape + (N_LIMBS,)).reshape(n, N_LIMBS) for c in P)
        out = cuda_ec.e2_scalar_mul(self, flat, words, n_bits, inner, nrows)
        return PointW(*(c.reshape(shape + (N_LIMBS,)) for c in out))

    # -- reductions -----------------------------------------------------

    def sum_points(self, P: PointW, axis: int = 0) -> PointW:
        """Point sum along one batch axis by a halving tree (one K2 launch
        per level; an odd level is padded with the identity)."""
        P = PointW(*(torch.movedim(c, axis, 0) for c in P))
        rest = P.batch_shape[1:]
        while P.batch_shape[0] > 1:
            n = P.batch_shape[0]
            if n % 2:
                P = cat_points([P, self.identity((1,) + rest, P.device)])
                n += 1
            P = self.add(take(P, slice(0, n // 2)), take(P, slice(n // 2, n)))
        if P.batch_shape[0] == 0:
            return self.identity(rest, P.device)
        return take(P, 0)


def bit_rows(bits: np.ndarray, shape):
    """How K3 reads ``bits`` (..., n_bits) for points of batch ``shape``:
    returns (inner, nrows, rows) with rows (nrows, n_bits) such that flat
    point i takes rows[(i // inner) % nrows].  The non-broadcast axes of
    ``bits`` must form one contiguous block of the full shape; otherwise the
    broadcast is materialised (inner = 1, one row per point)."""
    n_bits = bits.shape[-1]
    shape = tuple(shape)
    bshape = (1,) * (len(shape) - (bits.ndim - 1)) + tuple(bits.shape[:-1])
    live = [d for d, s in enumerate(bshape) if s != 1]
    if not live:
        return 1, 1, bits.reshape(1, n_bits)
    lo, hi = live[0], live[-1] + 1
    if all(bshape[d] == shape[d] for d in range(lo, hi)):
        nrows = int(np.prod(bshape[lo:hi], dtype=np.int64))
        inner = int(np.prod(shape[hi:], dtype=np.int64))
        return max(inner, 1), nrows, bits.reshape(nrows, n_bits)
    n = int(np.prod(shape, dtype=np.int64))
    full = np.broadcast_to(bits.reshape(bshape + (n_bits,)), shape + (n_bits,))
    return 1, n, full.reshape(n, n_bits)


def pack_bits(rows: np.ndarray) -> np.ndarray:
    """(r, n_bits) 0/1 bits LSB-first -> (r, max(1, ceil(n_bits/32))) uint32
    words (bit j of a scalar is bit j % 32 of word j // 32)."""
    rows = np.asarray(rows, dtype=np.uint8)
    r, n_bits = rows.shape
    n_words = max(1, -(-n_bits // 32))
    padded = np.zeros((r, 32 * n_words), dtype=np.uint8)
    padded[:, :n_bits] = rows
    packed = np.packbits(padded, axis=1, bitorder="little")   # (r, 4 W) bytes
    return np.ascontiguousarray(packed).view("<u4").reshape(r, n_words)


def scalars_to_bits(scalars, n_bits: int) -> np.ndarray:
    """Host ints (object ndarray / nested lists) -> LSB-first uint32 bits."""
    arr = np.asarray(scalars, dtype=object)
    vals = [int(v) for v in arr.reshape(-1)]
    if any(v < 0 for v in vals):
        raise ValueError("negative scalars must be pre-reduced mod group order")
    if any(v >> n_bits for v in vals):
        raise ValueError("scalar wider than n_bits")
    n_bytes = max(1, -(-n_bits // 8))
    buf = b"".join(v.to_bytes(n_bytes, "little") for v in vals)
    bytes_ = np.frombuffer(buf, dtype=np.uint8).reshape(len(vals), n_bytes)
    bits = np.unpackbits(bytes_, axis=1, bitorder="little")[:, :n_bits]
    return bits.astype(np.uint32).reshape(arr.shape + (n_bits,))


# Curve E2 over F_l (reference: src/convolution/Client.py:134-156).
E2 = WeierstrassCurve(FQ, E2_A, E2_B, E2_GX, E2_GY, E2_ORDER)
