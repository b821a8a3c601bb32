"""The 32-bit multiplies a step of the protocol needs, counted from the
cell's sizes (and, for the client's decryptions, from the plaintext values
the reference computes), never from what the program launched: the
numerator of ``mfu_pct``.

Every count is a lower bound of what the protocol needs with the best
method at hand, so that the share never reads too high:

* E2 (mod l, 17 products a complete addition, doublings included): a
  scalar multiplication of a b-bit scalar by a fixed base costs ceil(b/8)
  additions (an 8-bit comb over a table made once); by a variable base
  (b - 1) doublings and ceil(b/4) additions (4-bit windows).
* BSGS: a value v needs floor(|v| / m) + 1 giant steps on each of its two
  chains (the sign is not known); each candidate is one addition and its
  affine key, an inversion (3 products, batched by Montgomery's trick) and
  2 products.
* ristretto255 (mod p, 9 products an addition): a Hyrax commitment of N
  entries is sqrt-split into rows, each a bucket MSM at the best window c:
  ceil(253/c) (cols + 2^(c+1)) additions and 253 doublings.
* Spartan's sumchecks, by the reference's round structure: 10 products a
  pair of entries in a cubic round (4 binds, eq (A B - C) at 3 points), 4 in
  a quadratic one; A z, B z, C z one product a nonzero each.
* SPARK (full SNARK only): the comb_ops, comb_mem and derefs commitments;
  the memory-checking hashes (2 products a leaf), product trees (1 a leaf)
  and their layer sumchecks (5 a leaf); the dot-product circuits; the
  evaluations of the committed polynomials.
"""

from __future__ import annotations

from math import ceil
from typing import Dict, Iterable, List

import numpy as np

from .peaks import (MUL32_PER_PRODUCT_L, MUL32_PER_PRODUCT_P,
                    PRODUCTS_E2_ADD, PRODUCTS_ED_ADD)

SCALAR_BITS = 253


def pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def log2(n: int) -> int:
    return max(0, (int(n) - 1).bit_length())


def fixed_mul(bits: int) -> int:
    return ceil(bits / 8) if bits > 0 else 0


def var_mul(bits: int) -> int:
    return (bits - 1) + ceil(bits / 4) if bits > 0 else 0


class Count:
    """Products mod l and mod p; ``mul32`` turns them into multiplies."""

    def __init__(self):
        self.l = 0
        self.p = 0

    def e2(self, additions: int) -> None:
        self.l += PRODUCTS_E2_ADD * int(additions)

    def ed(self, additions: int) -> None:
        self.p += PRODUCTS_ED_ADD * int(additions)

    def mul32(self) -> int:
        return self.l * MUL32_PER_PRODUCT_L + self.p * MUL32_PER_PRODUCT_P


# ------------------------------------------------------------------ serving


def _bits(v) -> int:
    return abs(int(v)).bit_length()


def encrypt(c: Count, values: Iterable[int]) -> None:
    """r G and r h by fixed bases, |m| G by G, and one addition each."""
    for v in values:
        c.e2(2 * fixed_mul(SCALAR_BITS) + fixed_mul(_bits(v)) + 1)


def decrypt(c: Count, values: Iterable[int], m: int) -> None:
    """x c1 by a variable base, one subtraction, and the BSGS search."""
    for v in values:
        steps = abs(int(v)) // m + 1
        c.e2(var_mul(SCALAR_BITS) + 1 + 2 * steps)
        c.l += 2 * steps * (3 + 2)


def conv(c: Count, H: int, W: int, filt, padding: int, stride: int,
         rho_bits: int) -> None:
    """One ciphertext half through the conv and its rLC check."""
    f = len(filt)
    OH = (H + 2 * padding - f) // stride + 1
    OW = (W + 2 * padding - f) // stride + 1
    M, taps = OH * OW, f * f
    wmul = sum(var_mul(_bits(w)) for row in filt for w in row)
    c.e2(M * (wmul + taps - 1))                          # the output
    c.e2(M * var_mul(rho_bits) + M - 1)                  # rLC left
    c.e2(M * taps * var_mul(rho_bits) + taps * (M - 1)   # rLC right
         + wmul + taps - 1)


def pool(c: Count, H: int, W: int, k: int, s: int, scale: int) -> None:
    M = ((H - k) // s + 1) * ((W - k) // s + 1)
    c.e2(M * (k * k - 1) + M * var_mul(_bits(scale)))


def fc(c: Count, weights: np.ndarray, rho_bits: int) -> None:
    """One half of an FC layer: the products, the bias adds, the rLC left
    over the outputs and the right over the rho-combined columns."""
    n_in, n_out = weights.shape
    c.e2(sum(var_mul(_bits(w)) for w in weights.reshape(-1))
         + (n_in - 1) * n_out + n_out)
    c.e2(n_out * var_mul(rho_bits) + n_out - 1)
    c.e2(n_in * var_mul(rho_bits) + n_in - 1)


def serve_conv(cfg: Dict, size: int) -> int:
    """mul32 of one single-conv request (encrypt, conv with rLC, 2 halves)."""
    c = Count()
    encrypt(c, [(1 << 16) - 1] * (size * size))
    for _ in range(2):
        conv(c, size, size, cfg["filter"], cfg["padding"], cfg["stride"],
             8 * cfg["prf_trunc_bytes"])
    return c.mul32()


def serve_cnn(cfg: Dict, size: int, weights_fixed: Dict[str, np.ndarray],
              decrypted: List[np.ndarray]) -> int:
    """mul32 of one CNN request, its decryptions' values as the reference
    computed them (conv, pool, FC1, FC2 in order)."""
    c = Count()
    rho = 8 * cfg["prf_trunc_bytes"]
    k, s = cfg["pool"]
    m = cfg["bsgs_m"]
    f = len(cfg["filter"])
    OH = (size + 2 * cfg["padding"] - f) // cfg["stride"] + 1
    encrypt(c, [(1 << 16) - 1] * (size * size))
    for _ in range(2):
        conv(c, size, size, cfg["filter"], cfg["padding"], cfg["stride"], rho)
    decrypt(c, decrypted[0].reshape(-1), m)
    encrypt(c, [(1 << 16) - 1] * (OH * OH))
    for _ in range(2):
        pool(c, OH, OH, k, s, int((1.0 / (k * k)) * 2 ** 10))
    decrypt(c, decrypted[1].reshape(-1), m)
    encrypt(c, [(1 << 16) - 1] * len(decrypted[1].reshape(-1)))
    for i, layer in enumerate(("fc1", "fc2")):
        w = weights_fixed[f"weight_{layer}"]
        encrypt(c, weights_fixed[f"bias_{layer}"])
        for _ in range(2):
            fc(c, w, rho)
        decrypt(c, decrypted[2 + i].reshape(-1), m)
        if layer == "fc1":
            encrypt(c, [(1 << 16) - 1] * w.shape[1])
    return c.mul32()


# ------------------------------------------------------------------- proofs


def hyrax_commit(c: Count, n: int) -> None:
    """A Hyrax commitment of n entries: rows of bucket MSMs."""
    n = pow2(n)
    rows = 1 << (log2(n) // 2)
    cols = n // rows
    best = min(ceil(SCALAR_BITS / w) * (cols + (1 << (w + 1)))
               for w in range(1, 17))
    c.ed(rows * (best + SCALAR_BITS))


def prove(shape: Dict, full_snark: bool, gadget: str, count: int,
          n_bits: int) -> int:
    """mul32 of one proof and its verification, from the R1CS's sizes
    (num_cons, num_vars, num_inputs, nnz as the gadget builds them)."""
    c = Count()
    nc = pow2(max(shape["num_cons"], 2))
    nv = pow2(max(shape["num_vars"], shape["num_inputs"] + 1))
    nnz = int(shape["nnz"])
    # the witness: an affine addition a point add (an inversion, batched,
    # and 3 products); a double and an add a bit of each point mult
    c.l += count * 6 if gadget == "add" else count * n_bits * 2 * 6
    hyrax_commit(c, nv)                                   # the witness
    # the sat proof: A z, B z, C z, eq, the two sumchecks, the z evaluation
    c.l += 3 * nnz + nc + 10 * nc + 3 * nnz + nc + 4 * 2 * nv + nv
    rounds = log2(nc) + log2(2 * nv)
    c.ed(rounds * (SCALAR_BITS + 4))                      # round commitments
    if full_snark:
        N = pow2(nnz)
        mem = 1 << (max(log2(nc), log2(2 * nv)) + 1)
        hyrax_commit(c, 16 * N)                           # comb_ops
        hyrax_commit(c, mem)                              # comb_mem
        hyrax_commit(c, 8 * N)                            # derefs
        leaves = 12 * N + 4 * mem
        c.l += 2 * leaves + leaves + 5 * leaves           # hash, trees, layers
        c.l += 2 * 6 * N                                  # dot products
        c.l += 16 * N + 8 * N + 2 * mem                   # evaluations
    else:
        c.l += 3 * nnz                                    # the verifier's A, B, C
    return c.mul32()
