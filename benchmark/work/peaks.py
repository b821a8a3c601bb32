"""The card's peaks and the cost of one field product, as the yardstick
counts them (frozen from the repository's chip_smoke.py bound arithmetic).

H100 SXM: 32-bit integer multiply and multiply-add issue at 64 results a
clock an SM (CUDA C++ Programming Guide, throughput of native arithmetic
instructions, compute capability 9.0), 132 SMs at 1.98 GHz: 16.73 T
multiplies a second.  HBM3: 3.35 TB/s (NVIDIA data sheet).  Both assume the
full 700 W power limit; a run prints the card's limit beside its numbers.
"""

from __future__ import annotations

MUL32_PER_S = 64 * 132 * 1.98e9          # 16.73e12
HBM_BYTES_PER_S = 3.35e12

#: one CIOS Montgomery product over 8 x 32-bit limbs mod l: 64 limb products
#: for a*b and 64 for m*N, each a lo and a hi multiply, plus 8 for m
MUL32_PER_PRODUCT_L = 2 * 64 + 2 * 64 + 8       # 264
#: the same mod p = 2^255 - 19: m*p as m*2^255 - 19*m
MUL32_PER_PRODUCT_P = 2 * 64 + 8 + 2 * 8        # 152
#: products of one complete E2 addition (RCB15 Alg. 1, general a), mod l
PRODUCTS_E2_ADD = 17
#: products of one extended ristretto255 addition, mod p
PRODUCTS_ED_ADD = 9

L_MODULUS = 2 ** 252 + 27742317777372353535851937790883648493
P_25519 = 2 ** 255 - 19


def bound_s(mul32: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the multiplies over the
    multiply rate and the bytes over the memory rate."""
    return max(mul32 / MUL32_PER_S, nbytes / HBM_BYTES_PER_S)
