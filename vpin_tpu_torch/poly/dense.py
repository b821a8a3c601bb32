"""Dense multilinear polynomials with host or tensor eval tables.

Port of vpin_tpu/poly/dense.py (reference Spartan/src/dense_mlpoly.rs):
  * tables longer than HOST_POLY_MAX live as FQ limb tensors (n, 8) in
    Montgomery form on the device; binding a variable is one batched
    expression of K1 products;
  * smaller tables live as host int lists, where a round over a few
    thousand entries beats the launches, unless a mesh is active: then
    every table is a tensor and binds split over it (parallel/ops.py).
HOST_POLY_MAX has the reference's value, so each size takes the same route
in both packages; it is read at call time, so tests can lower it.  Both
routes give the same protocol values (exact arithmetic mod l).
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..field import FQ, L_MODULUS
from ..field import limbs as L
from ..parallel.mesh import get_mesh
from ..parallel.ops import sharded_bound_top

#: tables at or below this length use host int lists
HOST_POLY_MAX = 8192

#: entries of Z that bound_L multiplies and sums at a time (whole rows): a
#: chunk's K1 products and the int64 words of its sum tree come to about
#: 0.4 KB an entry, 1.7 GB at 2^22, where SPARK opens comb_ops of 2^27
#: entries at LeNet L3; 2^22 / R chunks of about 30 launches a tree level
_BOUND_CHUNK_ELEMS = 1 << 22


def host_tables_wanted(n: int) -> bool:
    """Host backend for a table of length n?  Tensors win when a mesh is
    active (so that the sharded entries run) or the table is large."""
    return n <= HOST_POLY_MAX and get_mesh() is None


def ints_to_dev(vals: Sequence[int], device=None) -> torch.Tensor:
    return FQ.to_mont([int(v) % L_MODULUS for v in vals],
                      resolve_device(device))


def small_ints_to_dev(arr, device=None) -> torch.Tensor:
    """Nonnegative int64 numpy array -> Montgomery limb tensor on ``device``:
    the two low limbs split out in bulk, then one K1 product by R^2 (no
    per-element Python; SPARK's addresses and timestamps)."""
    arr = np.asarray(arr, dtype=np.int64)
    if arr.size and arr.min() < 0:
        raise ValueError("small_ints_to_dev takes nonnegative ints")
    limbs = np.zeros(arr.shape + (L.N_LIMBS,), dtype=np.uint32)
    limbs[..., 0] = (arr & L.MASK32).astype(np.uint32)
    limbs[..., 1] = (arr >> 32).astype(np.uint32)
    plain = L.to_tensor(limbs, resolve_device(device))
    return FQ.mul(plain, L.to_tensor(FQ.R2_np, plain.device))


def dev_to_ints(arr: torch.Tensor) -> List[int]:
    return [int(v) for v in FQ.from_mont(arr).reshape(-1)]


def eq_evals(r: Sequence[int], device=None) -> torch.Tensor:
    """Full 2^ell eq table on ``device``, r_0 on the most significant index
    bit (reference convention): one doubling step per variable, a K1
    product over the table so far."""
    dev = resolve_device(device)
    evals = FQ.ones((1,), dev)
    if not r:
        return evals
    rs = ints_to_dev(r, dev)
    for j in range(len(r)):
        hi = FQ.mul(evals, rs[j])
        evals = torch.stack([FQ.sub(evals, hi), hi], dim=1).reshape(-1, L.N_LIMBS)
    return evals


def eq_evals_host(r: Sequence[int]) -> List[int]:
    """Full 2^ell eq table as host ints (doubling construction, reference
    dense_mlpoly.rs:78-94)."""
    evals = [1]
    for rj in r:
        rj = int(rj) % L_MODULUS
        nxt = []
        for v in evals:
            hi = v * rj % L_MODULUS
            nxt.append((v - hi) % L_MODULUS)
            nxt.append(hi)
        evals = nxt
    return evals


def eq_eval_single(r: Sequence[int], rx: Sequence[int]) -> int:
    """eq(r, rx) as an exact host int (reference EqPolynomial::evaluate)."""
    acc = 1
    for a, b in zip(r, rx):
        acc = acc * ((a * b + (1 - a) * (1 - b)) % L_MODULUS) % L_MODULUS
    return acc


def factored_lens(ell: int):
    return ell // 2, ell - ell // 2


class DensePoly:
    """Mutable dense multilinear polynomial over FQ, backed by either a
    Montgomery limb tensor (``Z``) or a host int list (``Zh``)."""

    def __init__(self, Z: Union[torch.Tensor, List[int]]):
        if isinstance(Z, list):
            n = len(Z)
            self.Zh: List[int] = Z
            self.Z = None
        else:
            if Z.dim() != 2 or Z.shape[-1] != L.N_LIMBS:
                raise ValueError("DensePoly takes an (n, 8) limb tensor")
            n = Z.shape[0]
            self.Z = Z
            self.Zh = None
        if n & (n - 1):
            raise ValueError("length must be a power of two")

    @property
    def is_host(self) -> bool:
        return self.Zh is not None

    @staticmethod
    def from_ints(vals: Sequence[int], device=None) -> "DensePoly":
        vals = [int(v) % L_MODULUS for v in vals]
        if host_tables_wanted(len(vals)):
            return DensePoly(vals)
        return DensePoly(ints_to_dev(vals, device))

    @property
    def len(self) -> int:
        return len(self.Zh) if self.is_host else self.Z.shape[0]

    @property
    def num_vars(self) -> int:
        return int(self.len).bit_length() - 1

    def bound_poly_var_top(self, r: int) -> None:
        r = int(r) % L_MODULUS
        if self.is_host:
            Zh = self.Zh
            n = len(Zh) // 2
            self.Zh = [(Zh[i] + r * (Zh[n + i] - Zh[i])) % L_MODULUS
                       for i in range(n)]
            return
        self.Z = bound_top(self.Z, r)

    def evaluate(self, r: Sequence[int]) -> int:
        if len(r) != self.num_vars:
            raise ValueError("evaluate: one point per variable")
        if self.is_host:
            chis = eq_evals_host(r)
            return sum(v * c for v, c in zip(self.Zh, chis)) % L_MODULUS
        chis = eq_evals(r, self.Z.device)
        return int(FQ.from_mont(FQ.dot(self.Z, chis)))

    def bound_L(self, L_vec):
        """L^T Z with Z viewed as an (L_size x R_size) matrix -> (R_size,)
        vector (reference DensePolynomial::bound).  Host polys take and
        return host int lists; tensor polys an (L_size, 8) tensor."""
        lnv, rnv = factored_lens(self.num_vars)
        L_size, R_size = 1 << lnv, 1 << rnv
        if self.is_host:
            Zh = self.Zh
            return [sum(int(L_vec[i]) * Zh[i * R_size + j]
                        for i in range(L_size)) % L_MODULUS
                    for j in range(R_size)]
        M = self.Z.reshape(L_size, R_size, L.N_LIMBS)
        step = 1 << (max(_BOUND_CHUNK_ELEMS // R_size, 1).bit_length() - 1)
        out = None
        for lo in range(0, L_size, step):
            part = FQ.sum_reduce(FQ.mul(L_vec[lo:lo + step, None, :],
                                        M[lo:lo + step]), axis=0)
            out = part if out is None else FQ.add(out, part)
        return out

    def index(self, i: int) -> int:
        if self.is_host:
            return self.Zh[i]
        return int(FQ.from_mont(self.Z[i]))


def bound_top(Z: torch.Tensor, r: int) -> torch.Tensor:
    """Bind the top variable of an (n, 8) table to r: lo + r (hi - lo),
    the half axis split over the active mesh when one is set."""
    out = sharded_bound_top(Z, r)
    if out is not None:
        return out
    n = Z.shape[0] // 2
    return bind_halves(Z[:n], Z[n:], FQ.to_mont([r], Z.device)[0])


def bind_halves(lo: torch.Tensor, hi: torch.Tensor,
                r_dev: torch.Tensor) -> torch.Tensor:
    """lo + r (hi - lo) for a Montgomery scalar r on their device."""
    return FQ.add(lo, FQ.mul(r_dev, FQ.sub(hi, lo)))
