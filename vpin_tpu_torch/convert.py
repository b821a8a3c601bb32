"""Carry state between vpin_tpu's arrays and the port's tensors.

vpin_tpu keeps a field element as 16 little-endian 16-bit limbs in a uint32
array (..., 16); the port as 8 little-endian 32-bit limbs in an int32 tensor
(..., 8).  Both are Montgomery residues for R = 2^256, so the values are the
same and the two layouts repack losslessly.  This module takes numpy arrays
(``np.asarray`` of a JAX array) and imports nothing of JAX or vpin_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve.ristretto import PointE
from .curve.weierstrass import PointW
from .device import resolve_device
from .field.limbs import to_numpy, to_tensor
from .nn.elgamal import KeyPair
from .snark.r1cs import SparseMat


def limbs16_to_32(arr) -> np.ndarray:
    """(..., 16) 16-bit limbs -> (..., 8) uint32 32-bit limbs."""
    a = np.asarray(arr, dtype=np.uint32)
    if a.shape[-1] != 16 or (a >> 16).any():
        raise ValueError("expected (..., 16) limbs of 16 bits")
    return a[..., 0::2] | (a[..., 1::2] << 16)


def limbs32_to_16(arr) -> np.ndarray:
    """(..., 8) uint32 32-bit limbs -> (..., 16) 16-bit limbs in uint32."""
    a = np.asarray(arr, dtype=np.uint32)
    out = np.empty(a.shape[:-1] + (16,), dtype=np.uint32)
    out[..., 0::2] = a & 0xFFFF
    out[..., 1::2] = a >> 16
    return out


def tensor_from_jax(arr, device=None) -> torch.Tensor:
    """vpin_tpu limbs (..., 16) -> port limbs (..., 8) on ``device``."""
    return to_tensor(limbs16_to_32(arr), resolve_device(device))


def tensor_to_jax(t: torch.Tensor) -> np.ndarray:
    """Port limbs (..., 8) -> vpin_tpu limbs (..., 16) as numpy."""
    return limbs32_to_16(to_numpy(t))


def point_from_jax(P, device=None) -> PointW:
    """vpin_tpu PointW (any (x, y, z) of (..., 16) arrays) -> port PointW."""
    return PointW(*(tensor_from_jax(c, device) for c in P))


def point_to_jax(P: PointW) -> tuple:
    """Port PointW -> (x, y, z) numpy arrays in vpin_tpu's limbs."""
    return tuple(tensor_to_jax(c) for c in P)


def pointe_from_jax(P, device=None) -> PointE:
    """vpin_tpu PointE (any (x, y, z, t) of (..., 16) arrays) -> port
    PointE."""
    return PointE(*(tensor_from_jax(c, device) for c in P))


def pointe_to_jax(P: PointE) -> tuple:
    """Port PointE -> (x, y, z, t) numpy arrays in vpin_tpu's limbs."""
    return tuple(tensor_to_jax(c) for c in P)


def fq_vector_from_jax(arr, device=None) -> torch.Tensor:
    """A vpin_tpu Montgomery FQ vector (n, 16) (a witness, an eval table)
    -> port limbs (n, 8)."""
    t = tensor_from_jax(arr, device)
    if t.dim() != 2:
        raise ValueError("expected an (n, 16) vector of field elements")
    return t


def keypair_from_jax(key, device=None) -> KeyPair:
    """Port KeyPair with the same secret as a vpin_tpu KeyPair."""
    return KeyPair.from_secret(int(key.x), device)


def sparse_mat_from_jax(m) -> SparseMat:
    """A vpin_tpu SparseMat (rows, cols, codes into a value codebook) -> the
    port's, with the same entries, codebook and codes."""
    book = [int(v) for v in m.codebook]
    codes = np.asarray(m.codes, dtype=np.int64)
    vals = np.empty(len(codes), dtype=object)
    vals[:] = [book[k] for k in codes]
    out = SparseMat((np.asarray(m.rows), np.asarray(m.cols), vals),
                    m.num_rows, m.num_cols_hint)
    if out.codebook != book or not np.array_equal(out.codes, codes):
        raise ValueError("sparse_mat_from_jax: codebook order differs")
    return out
