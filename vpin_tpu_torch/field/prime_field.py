"""Batched prime-field arithmetic on int32 limb tensors (..., 8).

Port of vpin_tpu/field/prime_field.py.  Elements stay in Montgomery form
(R = 2^256) with canonical limbs in [0, N), so every operation's result is a
unique limb pattern equal to vpin_tpu's.  ``mul`` is kernel K1
(field/cuda_mont.py), and so is ``pow_bits`` (its ``mont_pow`` entry), under
``inv``; add, sub and select are plain tensor code, as they were plain jnp
code in the reference.

  FQ : l = 2^252 + 27742317777372353535851937790883648493 (base field of E2)
  FP : p = 2^255 - 19 (coordinate field of ristretto255)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..device import resolve_device
from . import limbs as L
from .cuda_mont import mont_mul, mont_pow


class DeviceConsts(NamedTuple):
    """A field's constants as int64 working limbs on one device."""
    n32: torch.Tensor     # (8,) N in 32-bit limbs
    n16: torch.Tensor     # (16,) N in 16-bit limbs
    n0inv16: int          # -N^-1 mod 2^16


class PrimeField:
    """A prime field with batched limb arithmetic in Montgomery form."""

    def __init__(self, modulus: int, name: str = "F"):
        self.modulus = modulus
        self.name = name
        self.num_bits = modulus.bit_length()
        R = 1 << 256
        self.R = R % modulus
        self.R2 = (self.R * self.R) % modulus
        self.N_np = L.int_to_limbs(modulus)
        self.R_np = L.int_to_limbs(self.R)        # one, Montgomery form
        self.R2_np = L.int_to_limbs(self.R2)
        n0inv32 = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        # FieldConsts of csrc/field.cuh: n[8], one[8], n0inv
        self.kernel_words = [*self.N_np, *self.R_np, n0inv32]
        self.kernel_consts = kernels.consts_array(self.kernel_words)
        self._n0inv16 = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self._inv_exp_bits = tuple(int(b) for b in bin(modulus - 2)[2:])
        self._consts = {}

    def consts(self, device) -> DeviceConsts:
        key = str(device)
        c = self._consts.get(key)
        if c is None:
            n32 = L.widen(L.to_tensor(self.N_np, device))
            c = DeviceConsts(n32, L.halves(n32), self._n0inv16)
            self._consts[key] = c
        return c

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------

    def to_limb_array(self, ints) -> np.ndarray:
        """Host ints (any nesting) -> plain (non-Montgomery) uint32 limbs."""
        arr = np.asarray(ints, dtype=object)
        red = np.empty(arr.shape, dtype=object)
        red.reshape(-1)[:] = [int(v) % self.modulus for v in arr.reshape(-1)]
        return L.ints_to_limbs(red)

    def to_mont(self, ints, device=None) -> torch.Tensor:
        """Host ints (any nesting) -> Montgomery-form limbs on ``device``."""
        plain = L.to_tensor(self.to_limb_array(ints), resolve_device(device))
        return self.mul(plain, L.to_tensor(self.R2_np, plain.device))

    def from_mont(self, t: torch.Tensor) -> np.ndarray:
        """Montgomery-form limbs -> numpy object array of host ints."""
        one_plain = L.to_tensor(L.int_to_limbs(1), t.device)
        return L.limbs_to_ints(L.to_numpy(self.mul(t, one_plain)))

    def mont_limbs_np(self, v: int) -> np.ndarray:
        """Host int -> Montgomery-form uint32 limbs on the host."""
        return L.int_to_limbs(int(v) % self.modulus * self.R % self.modulus)

    def zeros(self, shape=(), device=None) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (L.N_LIMBS,), dtype=torch.int32,
                           device=resolve_device(device))

    def ones(self, shape=(), device=None) -> torch.Tensor:
        one = L.to_tensor(self.R_np, resolve_device(device))
        return one.expand(tuple(shape) + (L.N_LIMBS,)).clone()

    # ------------------------------------------------------------------
    # batched ops on canonical Montgomery limbs
    # ------------------------------------------------------------------

    def add(self, a, b):
        k = self.consts(a.device)
        return L.narrow(L.add_mod(L.widen(a), L.widen(b), k.n32))

    def sub(self, a, b):
        k = self.consts(a.device)
        return L.narrow(L.sub_mod(L.widen(a), L.widen(b), k.n32))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        """Montgomery product a * b * R^-1 mod N: kernel K1."""
        return mont_mul(a, b, self)

    def select(self, mask, a, b):
        mask = torch.as_tensor(mask, dtype=torch.bool, device=a.device)
        return torch.where(mask.unsqueeze(-1), a, b)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    def pow_bits(self, a, bits):
        """a^e for a host exponent given as MSB-first bits: square, and
        multiply where the bit is set.  K1's ``mont_pow``: one launch."""
        return mont_pow(a, bits, self)

    def inv(self, a):
        """Batched inverse via Fermat (a^(N-2)); inv(0) = 0."""
        return self.pow_bits(a, self._inv_exp_bits)

    def sum_reduce(self, a, axis: int = 0):
        """Field sum along one batch axis by a halving tree (an odd level is
        padded with zero).  Addition is exact mod N, so any association
        gives the same canonical limbs as the reference's strided scan."""
        a = torch.movedim(a, axis, 0)
        if a.shape[0] == 0:
            return torch.zeros_like(a[0:1]).expand(a.shape[1:]).clone()
        while a.shape[0] > 1:
            n = a.shape[0]
            if n % 2:
                a = torch.cat([a, torch.zeros_like(a[:1])])
                n += 1
            a = self.add(a[:n // 2], a[n // 2:])
        return a[0]

    def dot(self, a, b, axis: int = 0):
        """Field inner product along an axis."""
        return self.sum_reduce(self.mul(a, b), axis=axis)

    def limbs_to_bits(self, a_plain, n_bits: int = 253):
        """Plain (non-Montgomery) limbs (..., 8) -> LSB-first bits
        (..., n_bits) as int32 0/1."""
        shifts = torch.arange(L.LIMB_BITS, device=a_plain.device)
        bits = (L.widen(a_plain).unsqueeze(-1) >> shifts) & 1
        return bits.reshape(a_plain.shape[:-1] + (256,))[..., :n_bits].to(
            torch.int32)

    # ------------------------------------------------------------------
    # host scalar helpers (exact Python ints; the transcript uses them)
    # ------------------------------------------------------------------

    def from_bytes(self, b: bytes) -> int:
        v = int.from_bytes(b, "little")
        if v >= self.modulus:
            raise ValueError("non-canonical bytes")
        return v

    def from_bytes_mod_order(self, b: bytes) -> int:
        return int.from_bytes(b, "little") % self.modulus

    def from_bytes_wide(self, b: bytes) -> int:
        if len(b) != 64:
            raise ValueError("from_bytes_wide takes 64 bytes")
        return int.from_bytes(b, "little") % self.modulus

    def to_bytes(self, v: int) -> bytes:
        return int(v % self.modulus).to_bytes(32, "little")


L_MODULUS = 2**252 + 27742317777372353535851937790883648493
P_MODULUS = 2**255 - 19

FQ = PrimeField(L_MODULUS, name="Fl")   # E2 base field == ristretto scalar field
FP = PrimeField(P_MODULUS, name="Fp")   # ristretto255 coordinate field
