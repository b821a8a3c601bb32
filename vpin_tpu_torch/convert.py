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
from .nn.bsgs import BsgsTable
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


def bsgs_table_from_jax(table) -> BsgsTable:
    """A vpin_tpu BsgsTable (or anything with ``m``, ``keys_sorted`` and
    ``perm``) -> the port's, with copies of the same host arrays."""
    keys = np.array(table.keys_sorted, dtype=np.uint64)
    perm = np.array(table.perm, dtype=np.int64)
    if keys.shape != perm.shape or keys.ndim != 1:
        raise ValueError("bsgs_table_from_jax: keys and perm differ in shape")
    return BsgsTable(int(table.m), keys, perm)


def bsgs_table_to_jax(table: BsgsTable) -> tuple:
    """The port's table -> (m, keys_sorted, perm) as numpy arrays, the
    arguments of vpin_tpu's BsgsTable constructor."""
    return (table.m, np.array(table.keys_sorted, dtype=np.uint64),
            np.array(table.perm, dtype=np.int64))


def weights_from_jax(weights) -> dict:
    """FC weights (weight_fc1, bias_fc1, weight_fc2, bias_fc2; numpy or JAX
    arrays) -> a dict of float32 numpy arrays, with the shapes checked:
    (n_in, n_hidden), (n_hidden,), (n_hidden, n_out), (n_out,)."""
    out = {k: np.array(weights[k], dtype=np.float32)
           for k in ("weight_fc1", "bias_fc1", "weight_fc2", "bias_fc2")}
    w1, b1, w2, b2 = (out[k].shape for k in
                      ("weight_fc1", "bias_fc1", "weight_fc2", "bias_fc2"))
    if len(w1) != 2 or len(w2) != 2 or b1 != (w1[1],) or w2[0] != w1[1] \
            or b2 != (w2[1],):
        raise ValueError(f"weights_from_jax: inconsistent shapes {w1}, {b1}, "
                         f"{w2}, {b2}")
    return out
