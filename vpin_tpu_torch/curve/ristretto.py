"""ristretto255, batched on int32 limb tensors (the commitment group).

Port of vpin_tpu/curve/ristretto.py with curve/padded.py folded in: every
method takes any batch shape (the reference padded batches to powers of two
only to bound XLA compiles).  Extended-coordinate Edwards arithmetic over
F_p (p = 2^255 - 19), RFC 9496 encode/decode and the Elligator map.
Addition is kernel K4 (curve/cuda_edwards.py) for every batch size, the
whole double-and-add ladder of ``scalar_mul_bits`` is kernel K5, and the
field products under encode/decode are kernel K1.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from ..field import FP
from ..field import limbs as L
from . import cuda_edwards
from .weierstrass import bit_rows, pack_bits
from .host_ristretto import (
    BASE_X, BASE_Y, D, D_MINUS_ONE_SQ, INVSQRT_A_MINUS_D, ONE_MINUS_D_SQ, P,
    RISTRETTO_BASEPOINT_COMPRESSED, SQRT_AD_MINUS_ONE, SQRT_M1,
)

__all__ = ["PointE", "RistrettoGroup", "RISTRETTO", "P", "D", "SQRT_M1",
           "ONE_MINUS_D_SQ", "D_MINUS_ONE_SQ", "SQRT_AD_MINUS_ONE",
           "INVSQRT_A_MINUS_D", "BASE_X", "BASE_Y",
           "RISTRETTO_BASEPOINT_COMPRESSED", "take", "cat_points"]


class PointE(NamedTuple):
    """Batch of extended-coordinate Edwards points (X:Y:Z:T), T = XY/Z;
    each leaf (..., 8) int32 limbs in Montgomery form."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[:-1])

    @property
    def device(self) -> torch.device:
        return self.x.device


def take(Pp: PointE, idx) -> PointE:
    """Pp indexed on its batch axes."""
    return PointE(*(c[idx] for c in Pp))


def cat_points(points, dim: int = 0) -> PointE:
    return PointE(*(torch.cat([p[i] for p in points], dim) for i in range(4)))


#: the group's constants, by name, as host ints (Montgomery form on use)
_CONSTS = {"d2": 2 * D % P, "d": D, "sqrt_m1": SQRT_M1,
           "one_minus_d_sq": ONE_MINUS_D_SQ, "d_minus_one_sq": D_MINUS_ONE_SQ,
           "sqrt_ad_minus_one": SQRT_AD_MINUS_ONE,
           "invsqrt_a_minus_d": INVSQRT_A_MINUS_D,
           "base_x": BASE_X, "base_y": BASE_Y, "base_t": BASE_X * BASE_Y % P}


class RistrettoGroup:
    F = FP

    def __init__(self):
        # EdConsts of csrc/ed_add.cu: FieldConsts, d2[8]
        self.kernel_consts = kernels.consts_array(
            [*FP.kernel_words, *FP.mont_limbs_np(_CONSTS["d2"])])
        self._sqrt_exp_bits = tuple(int(b) for b in bin((P - 5) // 8)[2:])
        self._dev = {}

    def const(self, name: str, device) -> torch.Tensor:
        """A named constant as Montgomery limbs (8,) on ``device``."""
        key = (name, str(device))
        c = self._dev.get(key)
        if c is None:
            c = L.to_tensor(FP.mont_limbs_np(_CONSTS[name]), device)
            self._dev[key] = c
        return c

    def device_d2(self, device) -> torch.Tensor:
        """2d as int64 working limbs on ``device`` (the plain K4)."""
        return L.widen(self.const("d2", device))

    def _plain(self, value: int, device) -> torch.Tensor:
        return L.to_tensor(L.int_to_limbs(value), device)

    # -- constructors ---------------------------------------------------

    def identity(self, shape=(), device=None) -> PointE:
        F = self.F
        return PointE(F.zeros(shape, device), F.ones(shape, device),
                      F.ones(shape, device), F.zeros(shape, device))

    def basepoint(self, shape=(), device=None) -> PointE:
        dev = resolve_device(device)
        full = tuple(shape) + (L.N_LIMBS,)
        bx, by, bt = (self.const(n, dev).expand(full).clone()
                      for n in ("base_x", "base_y", "base_t"))
        return PointE(bx, by, self.F.ones(shape, dev), bt)

    def from_host_xy(self, xs, ys, device=None) -> PointE:
        F = self.F
        xs, ys = [int(v) for v in xs], [int(v) for v in ys]
        dev = resolve_device(device)
        x = F.to_mont(xs, dev)
        y = F.to_mont(ys, dev)
        t = F.to_mont([a * b % P for a, b in zip(xs, ys)], dev)
        return PointE(x, y, F.ones((len(xs),), dev), t)

    # -- group law (unified a = -1 extended formulas; complete) ----------

    def add(self, Pp: PointE, Q: PointE) -> PointE:
        """P + Q over broadcastable batches: kernel K4."""
        return PointE(*cuda_edwards.ed_add(self, tuple(Pp), tuple(Q)))

    def double(self, Pp: PointE) -> PointE:
        return self.add(Pp, Pp)

    def neg(self, Pp: PointE) -> PointE:
        F = self.F
        return PointE(F.neg(Pp.x), Pp.y, Pp.z, F.neg(Pp.t))

    def select(self, mask, a: PointE, b: PointE) -> PointE:
        F = self.F
        return PointE(*(F.select(mask, x, y) for x, y in zip(a, b)))

    def eq(self, Pp: PointE, Q: PointE) -> torch.Tensor:
        """Ristretto equality (mod torsion): X1Y2 == Y1X2 or X1X2 == Y1Y2."""
        F = self.F
        x1y2 = F.mul(Pp.x, Q.y)
        y1x2 = F.mul(Pp.y, Q.x)
        x1x2 = F.mul(Pp.x, Q.x)
        y1y2 = F.mul(Pp.y, Q.y)
        return F.eq(x1y2, y1x2) | F.eq(x1x2, y1y2)

    def sum_points(self, Pp: PointE, axis: int = 0) -> PointE:
        """Point sum along one batch axis by a halving tree (one K4 launch
        per level; an odd level is padded with the identity)."""
        Pp = PointE(*(torch.movedim(c, axis, 0) for c in Pp))
        rest = Pp.batch_shape[1:]
        while Pp.batch_shape[0] > 1:
            n = Pp.batch_shape[0]
            if n % 2:
                Pp = cat_points([Pp, self.identity((1,) + rest, Pp.device)])
                n += 1
            Pp = self.add(take(Pp, slice(0, n // 2)), take(Pp, slice(n // 2, n)))
        if Pp.batch_shape[0] == 0:
            return self.identity(rest, Pp.device)
        return take(Pp, 0)

    # -- scalar multiplication -------------------------------------------

    def scalar_mul_bits(self, Pp: PointE, bits) -> PointE:
        """[k]P where ``bits`` is a host array (..., n_bits) of LSB-first 0/1
        bits whose batch shape broadcasts to P's: kernel K5, the whole ladder
        in one launch, bit-equal to the reference's scan of ladder steps."""
        bits = np.asarray(bits)
        n_bits = bits.shape[-1]
        shape = tuple(np.broadcast_shapes(Pp.batch_shape, bits.shape[:-1]))
        n = int(np.prod(shape, dtype=np.int64))
        inner, nrows, rows = bit_rows(bits, shape)
        words = L.to_tensor(pack_bits(rows), Pp.device)
        flat = tuple(c.expand(shape + (L.N_LIMBS,)).reshape(n, L.N_LIMBS)
                     for c in Pp)
        out = cuda_edwards.ed_ladder(self, flat, words, n_bits, inner, nrows)
        return PointE(*(c.reshape(shape + (L.N_LIMBS,)) for c in out))

    def msm_bits(self, Pp: PointE, bits) -> PointE:
        """sum_i bits_i * P_i over the leading batch axis (ladders, then the
        halving sum: limbs may differ from the reference's strided scan while
        the encodings are equal)."""
        return self.sum_points(self.scalar_mul_bits(Pp, bits), axis=0)

    # -- field square roots ---------------------------------------------

    def _sqrt_ratio_m1(self, u, v):
        """RFC 9496 SQRT_RATIO_M1: (was_square, +/-sqrt(u/v) abs'd)."""
        F = self.F
        i = self.const("sqrt_m1", u.device)
        v2 = F.mul(v, v)
        v3 = F.mul(v2, v)
        v7 = F.mul(F.mul(v3, v3), v)
        r = F.mul(F.mul(u, v3), F.pow_bits(F.mul(u, v7), self._sqrt_exp_bits))
        check = F.mul(v, F.mul(r, r))
        neg_u = F.neg(u)
        correct = F.eq(check, u)
        flipped = F.eq(check, neg_u)
        flipped_i = F.eq(check, F.mul(neg_u, i))
        r = F.select(flipped | flipped_i, F.mul(r, i), r)
        return correct | flipped, self._ct_abs(r)

    def _parity(self, a):
        """LSB of the canonical (non-Montgomery) value: 'is negative'."""
        canon = self.F.mul(a, self._plain(1, a.device))
        return (canon[..., 0] & 1) == 1

    def _ct_abs(self, a):
        return self.F.select(self._parity(a), self.F.neg(a), a)

    # -- ristretto encode / decode / one-way map ------------------------

    def encode(self, Pp: PointE) -> torch.Tensor:
        """-> the canonical s values of the 32-byte encodings, as plain
        (non-Montgomery) limbs (..., 8)."""
        F = self.F
        dev = Pp.device
        x0, y0, z0, t0 = Pp
        u1 = F.mul(F.add(z0, y0), F.sub(z0, y0))
        u2 = F.mul(x0, y0)
        _, invsqrt = self._sqrt_ratio_m1(F.ones(u1.shape[:-1], dev),
                                         F.mul(u1, F.mul(u2, u2)))
        den1 = F.mul(invsqrt, u1)
        den2 = F.mul(invsqrt, u2)
        z_inv = F.mul(F.mul(den1, den2), t0)
        i = self.const("sqrt_m1", dev)
        ix0 = F.mul(x0, i)
        iy0 = F.mul(y0, i)
        enchanted = F.mul(den1, self.const("invsqrt_a_minus_d", dev))
        rotate = self._parity(F.mul(t0, z_inv))
        x = F.select(rotate, iy0, x0)
        y = F.select(rotate, ix0, y0)
        den_inv = F.select(rotate, enchanted, den2)
        y = F.select(self._parity(F.mul(x, z_inv)), F.neg(y), y)
        s = self._ct_abs(F.mul(den_inv, F.sub(z0, y)))
        return F.mul(s, self._plain(1, dev))

    def decode(self, s_plain) -> Tuple[PointE, torch.Tensor]:
        """Canonical s values as plain limbs (..., 8) -> (points, valid).
        Canonicity and range checks are the caller's (host ints)."""
        F = self.F
        dev = s_plain.device
        s = F.mul(s_plain, L.to_tensor(F.R2_np, dev))       # to Montgomery
        one = F.ones(s.shape[:-1], dev)
        ss = F.mul(s, s)
        u1 = F.sub(one, ss)
        u2 = F.add(one, ss)
        u2_sqr = F.mul(u2, u2)
        du1sq = F.mul(self.const("d", dev), F.mul(u1, u1))
        v = F.sub(F.neg(du1sq), u2_sqr)
        was_square, invsqrt = self._sqrt_ratio_m1(one, F.mul(v, u2_sqr))
        den_x = F.mul(invsqrt, u2)
        den_y = F.mul(F.mul(invsqrt, den_x), v)
        x = self._ct_abs(F.mul(F.add(s, s), den_x))
        y = F.mul(u1, den_y)
        t = F.mul(x, y)
        valid = was_square & ~self._parity(t) & ~F.is_zero(y)
        return PointE(x, y, one, t), valid

    def elligator_map(self, r0) -> PointE:
        """RFC 9496 MAP: field element (Montgomery limbs) -> point."""
        F = self.F
        dev = r0.device
        one = F.ones(r0.shape[:-1], dev)
        d = self.const("d", dev)
        r = F.mul(self.const("sqrt_m1", dev), F.mul(r0, r0))
        u = F.mul(F.add(r, one), self.const("one_minus_d_sq", dev))
        v = F.mul(F.sub(F.neg(one), F.mul(r, d)), F.add(r, d))
        was_square, s = self._sqrt_ratio_m1(u, v)
        s_prime = F.neg(self._ct_abs(F.mul(s, r0)))
        s = F.select(was_square, s, s_prime)
        c = F.select(was_square, F.neg(one), r)
        N = F.sub(F.mul(F.mul(c, F.sub(r, one)),
                        self.const("d_minus_one_sq", dev)), v)
        w0 = F.mul(F.add(s, s), v)
        w1 = F.mul(N, self.const("sqrt_ad_minus_one", dev))
        ss = F.mul(s, s)
        w2 = F.sub(one, ss)
        w3 = F.add(one, ss)
        return PointE(F.mul(w0, w3), F.mul(w2, w1), F.mul(w1, w3),
                      F.mul(w0, w2))

    # -- host byte interfaces -------------------------------------------

    def encode_bytes(self, Pp: PointE) -> list:
        """-> list of 32-byte compressed encodings (row-major)."""
        limbs = L.to_numpy(self.encode(Pp)).reshape(-1, L.N_LIMBS)
        return [row.astype("<u4").tobytes() for row in limbs]

    def decode_bytes(self, encs: list, device=None) -> PointE:
        """list of 32-byte strings -> points; raises on an invalid one."""
        vals = []
        for e in encs:
            v = int.from_bytes(e, "little")
            if len(e) != 32 or v >= P or v % 2 == 1:
                raise ValueError("invalid ristretto encoding (non-canonical)")
            vals.append(v)
        arr = L.ints_to_limbs(np.asarray(vals, dtype=object).reshape(len(vals)))
        pts, valid = self.decode(L.to_tensor(arr, resolve_device(device)))
        if not bool(valid.all()):
            raise ValueError("invalid ristretto encoding (not a square)")
        return pts

    def from_uniform_bytes(self, chunks: list, device=None) -> PointE:
        """dalek RistrettoPoint::from_uniform_bytes: each chunk is 64 bytes;
        point = MAP(r0) + MAP(r1), r_i = low 255 bits of each half."""
        mask = (1 << 255) - 1
        r0s, r1s = [], []
        for ch in chunks:
            if len(ch) != 64:
                raise ValueError("from_uniform_bytes takes 64-byte chunks")
            r0s.append(int.from_bytes(ch[:32], "little") & mask)
            r1s.append(int.from_bytes(ch[32:], "little") & mask)
        dev = resolve_device(device)
        a = self.elligator_map(self.F.to_mont(r0s, dev))
        b = self.elligator_map(self.F.to_mont(r1s, dev))
        return self.add(a, b)


RISTRETTO = RistrettoGroup()
