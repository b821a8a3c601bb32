"""R1CS instances as sparse matrices with bucketed tensor reductions.

Port of vpin_tpu/snark/r1cs.py (reference Spartan/src/r1csinstance.rs,
sparse_mlpoly.rs:440-500):
  * entries live as numpy arrays (rows, cols) plus int32 codes into a small
    value codebook (gadget matrices draw their values from a tiny set);
  * multiply_vec / compute_eval_table group the entries of every row (resp.
    column) with the same nonzero count into one (m, k) gather, K1 product
    and tree sum, its rows split over the active mesh when one is set;
  * evaluate() contracts val * eq_rx[row] * eq_ry[col].
Instance::new padding semantics (pow2 cons/vars, input-column shift) follow
lib.rs:146-244.  Small instances keep every table on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..parallel.ops import sharded_regular_reduce
from ..poly.dense import (DensePoly, eq_evals, eq_evals_host,
                          host_tables_wanted, ints_to_dev)


def regular_reduce(vals: torch.Tensor, idx: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """out[s] = sum_k vals[s, k] * z[idx[s, k]]: vals (m, k, 8), idx (m, k)
    -> (m, 8), one K1 product and a tree sum."""
    return FQ.sum_reduce(FQ.mul(vals, z[idx]), axis=1)


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def _to_arrays(entries):
    """Entries (list of (row, col, val) tuples OR a (rows, cols, vals) array
    triple) -> (rows int64, cols int64, vals object ndarray)."""
    if isinstance(entries, tuple) and len(entries) == 3:
        rows, cols, vals = entries
        return (np.asarray(rows, dtype=np.int64),
                np.asarray(cols, dtype=np.int64),
                np.asarray(vals, dtype=object))
    rows = np.fromiter((int(e[0]) for e in entries), dtype=np.int64,
                       count=len(entries))
    cols = np.fromiter((int(e[1]) for e in entries), dtype=np.int64,
                       count=len(entries))
    vals = np.empty(len(entries), dtype=object)
    for i, e in enumerate(entries):
        vals[i] = int(e[2])
    return rows, cols, vals


def _bucket_layout(keys: np.ndarray, others: np.ndarray, codes: np.ndarray,
                   num_segments: int):
    """Group entries by segment id ``keys``: one (segs, idx, code) triple per
    distinct per-segment nonzero count."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    os_ = others[order]
    cs = codes[order]
    counts = np.bincount(ks, minlength=num_segments)
    buckets = []
    for k in np.unique(counts[counts > 0]):
        segs = np.where(counts == k)[0]
        sel = counts[ks] == k
        m = len(segs)
        buckets.append((segs.astype(np.int64),
                        os_[sel].reshape(m, int(k)).astype(np.int64),
                        cs[sel].reshape(m, int(k)).astype(np.int64)))
    return buckets


class SparseMat:
    """One sparse matrix as (rows, cols, value-codebook codes)."""

    def __init__(self, entries, num_rows: int, num_cols_hint: int):
        rows, cols, vals = _to_arrays(entries)
        self.rows = rows
        self.cols = cols
        self.num_rows = num_rows
        self.num_cols_hint = num_cols_hint
        # value codebook: code 0 is always the field zero
        book = {0: 0}
        codes = np.empty(len(vals), dtype=np.int32)
        for i, v in enumerate(vals):
            v = int(v) % L
            code = book.get(v)
            if code is None:
                code = len(book)
                book[v] = code
            codes[i] = code
        self.codes = codes
        self.codebook: List[int] = list(book.keys())
        self._book = {}
        self._row_buckets = None
        self._col_buckets = None

    @property
    def nnz(self) -> int:
        return int(len(self.rows))

    @property
    def entries(self) -> List[Tuple[int, int, int]]:
        """The (row, col, value) triples, columns shifted, in stored order
        (the instance digest reads them)."""
        cb = self.codebook
        return [(r, c, cb[k]) for r, c, k in zip(
            self.rows.tolist(), self.cols.tolist(), self.codes.tolist())]

    def _book_mont(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._book:
            self._book[key] = FQ.to_mont(self.codebook, device)
        return self._book[key]

    # -- bucketed reductions --------------------------------------------

    #: index elements (nonzeros) a reduction or evaluation handles at a
    #: time: a chunk's gathers, K1 products and the int64 words of its field
    #: sums come to about 0.5 KB an element, 2 GB at 2^22, where LeNet L5's
    #: matrices hold 2^25 nonzeros each (16 GB unchunked); a chunk costs
    #: about 30 launches a level of its sum tree, so larger chunks gain
    #: little.  (vpin_tpu's 2^20 was set by the TPU padding the 16-limb
    #: minor axis 8x; the card does not pad.)
    REDUCE_CHUNK_ELEMS = 1 << 22

    def _reduce_buckets(self, buckets, table: torch.Tensor,
                        out_len: int) -> torch.Tensor:
        """sum_k val * table[idx] per segment, scattered into (out_len, 8);
        a bucket's segments run in chunks of REDUCE_CHUNK_ELEMS index
        elements (rounded down to a power of two of segments), each split
        over the active mesh when one is set."""
        dev = table.device
        book = self._book_mont(dev)
        out = FQ.zeros((out_len,), dev)
        for segs, idx, code in buckets:
            m, k = idx.shape
            rows = 1 << (max(self.REDUCE_CHUNK_ELEMS // k, 1).bit_length() - 1)
            for lo in range(0, m, rows):
                hi = min(lo + rows, m)
                vals = book[torch.as_tensor(code[lo:hi], device=dev)]
                at = torch.as_tensor(idx[lo:hi], device=dev)
                part = sharded_regular_reduce(vals, at, table, hi - lo)
                if part is None:
                    part = regular_reduce(vals, at, table)
                out[torch.as_tensor(segs[lo:hi], device=dev)] = part
        return out

    def multiply_vec(self, num_cols: int, z: torch.Tensor) -> torch.Tensor:
        """-> (num_rows, 8) tensor M z; z: (num_cols, 8) Montgomery limbs."""
        if self._row_buckets is None:
            self._row_buckets = _bucket_layout(self.rows, self.cols,
                                               self.codes, self.num_rows)
        return self._reduce_buckets(self._row_buckets, z, self.num_rows)

    def compute_eval_table(self, evals_rx: torch.Tensor,
                           num_cols: int) -> torch.Tensor:
        """-> (num_cols, 8) tensor M^T evals_rx."""
        if self._col_buckets is None:
            self._col_buckets = _bucket_layout(self.cols, self.rows,
                                               self.codes, num_cols)
        return self._reduce_buckets(self._col_buckets, evals_rx, num_cols)

    # -- host paths (small instances and the verifier) -------------------

    def multiply_vec_host(self, z: List[int]) -> List[int]:
        cb = self.codebook
        out = [0] * self.num_rows
        for r, c, k in zip(self.rows.tolist(), self.cols.tolist(),
                           self.codes.tolist()):
            out[r] += cb[k] * z[c]
        return [v % L for v in out]

    def compute_eval_table_host(self, evals_rx: List[int],
                                num_cols: int) -> List[int]:
        cb = self.codebook
        out = [0] * num_cols
        for r, c, k in zip(self.rows.tolist(), self.cols.tolist(),
                           self.codes.tolist()):
            out[c] += cb[k] * evals_rx[r]
        return [v % L for v in out]

    def evaluate_host(self, eq_rx: List[int], eq_ry: List[int]) -> int:
        cb = self.codebook
        total = 0
        for r, c, k in zip(self.rows.tolist(), self.cols.tolist(),
                           self.codes.tolist()):
            total += cb[k] * eq_rx[r] % L * eq_ry[c]
        return total % L

    def evaluate(self, eq_rx: torch.Tensor, eq_ry: torch.Tensor,
                 chunk: Optional[int] = None) -> int:
        """sum val * eq_rx[row] * eq_ry[col] over the nonzeros, in pieces of
        ``chunk`` (REDUCE_CHUNK_ELEMS by default)."""
        dev = eq_rx.device
        book = self._book_mont(dev)
        chunk = chunk or self.REDUCE_CHUNK_ELEMS
        total = FQ.zeros((), dev)
        for lo in range(0, self.nnz, chunk):
            hi = min(lo + chunk, self.nnz)
            vals = book[torch.as_tensor(self.codes[lo:hi], device=dev)]
            rows = torch.as_tensor(self.rows[lo:hi], device=dev)
            cols = torch.as_tensor(self.cols[lo:hi], device=dev)
            prod = FQ.mul(FQ.mul(vals, eq_rx[rows]), eq_ry[cols])
            total = FQ.add(total, FQ.sum_reduce(prod, axis=0))
        return int(FQ.from_mont(total))


class R1CSInstance:
    """Padded R1CS instance (reference Instance::new semantics).  ``device``
    holds the prover's tables when the instance is too large for the host."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 A, B, C, device=None):
        num_vars_padded = _next_pow2(max(num_vars, num_inputs + 1))
        num_cons_padded = _next_pow2(max(num_cons, 2))

        def shift(entries):
            rows, cols, vals = _to_arrays(entries)
            if rows.size and (rows.max() >= num_cons
                              or cols.max() >= num_vars + 1 + num_inputs):
                raise ValueError("R1CS entry out of range")
            delta = num_vars_padded - num_vars
            if delta:
                cols = np.where(cols >= num_vars, cols + delta, cols)
            # the reference pads a dummy zero entry per constraint when the
            # original count was 0/1 (lib.rs:208-214)
            if num_cons in (0, 1):
                extra = np.arange(len(rows), num_cons_padded, dtype=np.int64)
                rows = np.concatenate([rows, extra])
                cols = np.concatenate(
                    [cols, np.full(len(extra), num_vars, np.int64)])
                zpad = np.zeros(len(extra), dtype=object)
                vals = np.concatenate([vals, zpad]) if len(vals) else zpad
            return (rows, cols, vals)

        self.device = device
        self.num_cons = num_cons_padded
        self.num_vars = num_vars_padded
        self.num_inputs = num_inputs
        ncols = 2 * num_vars_padded
        self.A = SparseMat(shift(A), num_cons_padded, ncols)
        self.B = SparseMat(shift(B), num_cons_padded, ncols)
        self.C = SparseMat(shift(C), num_cons_padded, ncols)
        self.total_nnz = self.A.nnz + self.B.nnz + self.C.nnz

    @property
    def host_mode(self) -> bool:
        """Small instances run the sat-proof table math on host ints."""
        return (host_tables_wanted(max(self.num_cons, 2 * self.num_vars))
                and self.total_nnz <= (1 << 17))

    # ------------------------------------------------------------------

    def build_z(self, vars_ints, inputs: Sequence[int]):
        """z = vars || 1 || inputs || 0-pad, length 2*num_vars.  vars_ints: a
        host int list OR a Montgomery tensor (num_vars, 8).  Returns a host
        int list in host mode, a tensor otherwise."""
        if isinstance(vars_ints, torch.Tensor):
            if vars_ints.shape[0] != self.num_vars:
                raise ValueError("build_z: vars must be padded to num_vars")
            dev = vars_ints.device
            tail = ints_to_dev([1] + list(inputs), dev)
            pad = FQ.zeros((self.num_vars - 1 - len(inputs),), dev)
            return torch.cat([vars_ints, tail, pad])
        if len(vars_ints) != self.num_vars:
            raise ValueError("build_z: vars must be padded to num_vars")
        z = [int(v) % L for v in vars_ints] + [1] + \
            [int(v) % L for v in inputs]
        z += [0] * (2 * self.num_vars - len(z))
        if self.host_mode:
            return z
        return ints_to_dev(z, self.device)

    def multiply_vec(self, z) -> Tuple[DensePoly, DensePoly, DensePoly]:
        if isinstance(z, list):
            return (DensePoly(self.A.multiply_vec_host(z)),
                    DensePoly(self.B.multiply_vec_host(z)),
                    DensePoly(self.C.multiply_vec_host(z)))
        ncols = 2 * self.num_vars
        return (DensePoly(self.A.multiply_vec(ncols, z)),
                DensePoly(self.B.multiply_vec(ncols, z)),
                DensePoly(self.C.multiply_vec(ncols, z)))

    def is_sat(self, vars_ints, inputs: Sequence[int]) -> bool:
        if isinstance(vars_ints, torch.Tensor):
            pad = FQ.zeros((self.num_vars - vars_ints.shape[0],),
                           vars_ints.device)
            z = self.build_z(torch.cat([vars_ints, pad]), inputs)
        else:
            vars_padded = list(vars_ints) + \
                [0] * (self.num_vars - len(vars_ints))
            z = self.build_z(vars_padded, inputs)
        Az, Bz, Cz = self.multiply_vec(z)
        if Az.is_host:
            return all(a * b % L == c
                       for a, b, c in zip(Az.Zh, Bz.Zh, Cz.Zh))
        return bool(FQ.eq(FQ.mul(Az.Z, Bz.Z), Cz.Z).all())

    def compute_eval_table_sparse(self, evals_rx):
        ncols = 2 * self.num_vars
        if isinstance(evals_rx, list):
            return (self.A.compute_eval_table_host(evals_rx, ncols),
                    self.B.compute_eval_table_host(evals_rx, ncols),
                    self.C.compute_eval_table_host(evals_rx, ncols))
        return (self.A.compute_eval_table(evals_rx, ncols),
                self.B.compute_eval_table(evals_rx, ncols),
                self.C.compute_eval_table(evals_rx, ncols))

    def evaluate(self, rx: Sequence[int], ry: Sequence[int]):
        """(A(rx, ry), B(rx, ry), C(rx, ry)), on the prover's route."""
        if self.host_mode:
            return self.evaluate_host(rx, ry)
        eq_rx = eq_evals(rx, self.device)
        eq_ry = eq_evals(ry, self.device)
        return tuple(M.evaluate(eq_rx, eq_ry) for M in (self.A, self.B, self.C))

    def evaluate_host(self, rx: Sequence[int], ry: Sequence[int]):
        """The same evaluations on host ints: the verifier's route at any
        size."""
        eq_rx = eq_evals_host(rx)
        eq_ry = eq_evals_host(ry)
        return tuple(M.evaluate_host(eq_rx, eq_ry)
                     for M in (self.A, self.B, self.C))
