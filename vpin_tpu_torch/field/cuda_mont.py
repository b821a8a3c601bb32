"""K1: batched Montgomery multiplication, a * b * 2^-256 mod N, and the
batched power a^e for one public exponent.

Port of vpin_tpu/field/pallas_mont.py (``mont_mul_pallas``) and of the
``lax.scan`` of it in vpin_tpu's ``PrimeField.pow_bits``.  The CUDA kernels
are csrc/mont_mul.cu (entries ``mont_mul`` and ``mont_pow``);
``mont_mul_plain`` and ``mont_pow_plain`` are the same functions in plain
PyTorch, the kernels' yardsticks on the card and what a CPU tensor runs.
"""

from __future__ import annotations

import torch

from .. import kernels
from .limbs import MASK16, N_LIMBS, carry, halves, narrow, reduce_once, widen


def mont_mul(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """Montgomery product of canonical int32 limb tensors (..., 8) with
    broadcastable batch shapes.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    dev = kernels.check_limbs("mont_mul", a, b)
    if dev.type == "cpu":
        return mont_mul_plain(a, b, field)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = kernels.kernel_operand(a, shape)
    b = kernels.kernel_operand(b, shape)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    n = out.numel() // N_LIMBS
    if n:
        kernels.launch("mont_mul", dev, a.data_ptr(), b.data_ptr(),
                       out.data_ptr(), n, field.kernel_consts)
    return out


def mont_pow(a: torch.Tensor, bits, field) -> torch.Tensor:
    """a^e in Montgomery form for canonical int32 limbs (..., 8), where
    ``bits`` is the exponent MSB first (at most 256 bits).  CPU tensors take
    the plain version; CUDA tensors launch the kernel once."""
    dev = kernels.check_limbs("mont_pow", a)
    bits = tuple(int(b) for b in bits)
    if len(bits) > 256 or any(b not in (0, 1) for b in bits):
        raise ValueError("mont_pow: the exponent must be at most 256 bits")
    if dev.type == "cpu":
        return mont_pow_plain(a, bits, field)
    a = kernels.kernel_operand(a, a.shape)
    out = torch.empty_like(a)
    n = out.numel() // N_LIMBS
    if n:
        e = int("".join(map(str, bits)) or "0", 2)
        words = kernels.consts_array([(e >> (32 * j)) & 0xFFFFFFFF
                                      for j in range(N_LIMBS)])
        kernels.launch("mont_pow", dev, a.data_ptr(), out.data_ptr(), n,
                       field.kernel_consts, words, len(bits))
    return out


def mont_pow_plain(a: torch.Tensor, bits, field) -> torch.Tensor:
    """The mont_pow kernel's function in plain PyTorch: from x = 1, square,
    and multiply by a where the bit is set, MSB first."""
    x = field.ones(a.shape[:-1], a.device)
    for bit in bits:
        x = mont_mul_plain(x, x, field)
        if bit:
            x = mont_mul_plain(x, a, field)
    return x


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """The kernel's function in plain PyTorch (int64 arithmetic)."""
    k = field.consts(a.device)
    return narrow(mont_mul64(widen(a), widen(b), k))


def _column_sums(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of 16-bit limb vectors without carries:
    (..., 16) x (..., 16) -> (..., 32) column sums, each < 2^36."""
    prod = A.unsqueeze(-1) * B.unsqueeze(-2)                  # (..., 16, 16)
    lead = prod.shape[:-2]
    # skew: row i shifted right by i, then summed over rows
    padded = torch.nn.functional.pad(prod, (0, 16))           # (..., 16, 32)
    flat = padded.reshape(lead + (16 * 32,))[..., :16 * 31]
    cols = flat.reshape(lead + (16, 31)).sum(-2)              # (..., 31)
    return torch.nn.functional.pad(cols, (0, 1))


def mont_mul64(a: torch.Tensor, b: torch.Tensor, k) -> torch.Tensor:
    """Montgomery product on int64 working limbs (..., 8) in [0, 2^32):
    column sums of the 16-bit schoolbook product, then 16 word-by-word
    reduction steps with lazy carries (every column stays < 2^39), one carry
    pass and one conditional subtract."""
    A, B = torch.broadcast_tensors(halves(a), halves(b))
    T = _column_sums(A, B)
    for i in range(16):
        m = ((T[..., i] & MASK16) * k.n0inv16) & MASK16
        T[..., i:i + 16] += m.unsqueeze(-1) * k.n16
        T[..., i + 1] += T[..., i] >> 16
    hi = T[..., 16:]
    x, _ = carry(hi[..., 0::2] + (hi[..., 1::2] << 16))      # < 2N < 2^256
    return reduce_once(x, k.n32)
