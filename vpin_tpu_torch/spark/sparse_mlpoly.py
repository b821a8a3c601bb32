"""SPARK: the sparse multilinear polynomial commitment and its evaluation
proof (the R1CS eval proof of the full SNARK).

Port of vpin_tpu/spark/sparse_mlpoly.py (reference Spartan
sparse_mlpoly.rs), bit for bit on the transcript:
  * offline-memory-checking timestamps (AddrTimestamps) by vectorised numpy
    group ranking;
  * the hashed multiset leaves, the grand-product trees and every sumcheck
    round as stacked batched expressions (spark/product_tree.py);
  * Hyrax commitments of comb_ops, comb_mem and the derefs through the table
    MSM (kernel K4), their openings through PolyEvalProof;
  * HashLayerProof, ProductLayerProof, PolyEvalNetworkProof and
    SparseMatPolyEvalProof with the reference's labels and append order.
Every instance runs on Montgomery tensors: vpin_tpu keeps those with comb_ops
up to HOST_POLY_MAX entries on host ints, but on the H100 the 16-add proof's
SPARK (4,096 entries) is as fast on tensors.  The verifier is host-only: every group equation defers into the caller's
VerifyAccumulator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..nizk.sigma import append_scalars_vector
from ..poly.dense import (DensePoly, eq_eval_single, eq_evals,
                          small_ints_to_dev)
from ..snark.r1csproof import (PolyCommitment, PolyCommitmentGens,
                               PolyEvalProof, poly_commit)
from ..transcript.merlin import RandomTape, Transcript
from ..utils.errors import InternalError, verify_guard
from .product_tree import (BatchedDotProducts, BatchedProductCircuits,
                           ProductCircuitEvalProofBatched)


def _next_pow2(n: int) -> int:
    m = 1
    while m < max(n, 1):
        m *= 2
    return m


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _concat_padded(parts) -> DensePoly:
    """Tensors concatenated and zero-padded to a power of two."""
    total = sum(p.shape[0] for p in parts)
    pad = _next_pow2(total) - total
    if pad:
        parts = list(parts) + [FQ.zeros((pad,), parts[0].device)]
    return DensePoly(torch.cat(parts))


# ----------------------------------------------------------------------
# dense representation with memory-checking timestamps
# ----------------------------------------------------------------------

class AddrTimestamps:
    """Read and audit timestamps of one address space (reference
    sparse_mlpoly.rs:224-283), vectorised: an op's read timestamp is the
    cell's count of earlier ops, from a stable sort by address."""

    def __init__(self, num_cells: int, num_ops: int,
                 ops_addr: List[np.ndarray]):
        self.num_cells = num_cells
        self.num_ops = num_ops
        self.ops_addr = [np.asarray(a, dtype=np.int64) for a in ops_addr]
        audit = np.zeros(num_cells, dtype=np.int64)
        self.read_ts: List[np.ndarray] = []
        for addr in self.ops_addr:
            # occurrence rank of each op among equal addresses (stable)
            order = np.argsort(addr, kind="stable")
            sorted_addr = addr[order]
            start = np.r_[True, sorted_addr[1:] != sorted_addr[:-1]]
            group_start = np.maximum.accumulate(
                np.where(start, np.arange(num_ops), 0))
            occ = np.empty(num_ops, dtype=np.int64)
            occ[order] = np.arange(num_ops) - group_start
            self.read_ts.append(audit[addr] + occ)
            np.add.at(audit, addr, 1)
        self.audit_ts = audit

    def deref(self, mem_val) -> list:
        return [mem_val[torch.as_tensor(addr, device=mem_val.device)]
                for addr in self.ops_addr]


class MultiSparseMatPolynomialAsDense:
    """The batch of sparse matrices as dense (row, col, val) op vectors with
    their timestamps, and comb_ops / comb_mem, the two committed polys."""

    def __init__(self, sparse_mats, num_vars_x: int, num_vars_y: int,
                 device=None):
        self.batch_size = len(sparse_mats)
        self.num_vars_x = num_vars_x
        self.num_vars_y = num_vars_y
        N = max(_next_pow2(m.nnz) for m in sparse_mats)
        self.N = N
        self.device = resolve_device(device)

        ops_row, ops_col, vals = [], [], []
        for m in sparse_mats:
            nnz = m.nnz
            row = np.zeros(N, dtype=np.int64)
            col = np.zeros(N, dtype=np.int64)
            codes = np.zeros(N, dtype=np.int64)   # code 0 == field zero
            row[:nnz] = m.rows
            col[:nnz] = m.cols
            codes[:nnz] = m.codes
            ops_row.append(row)
            ops_col.append(col)
            book = m._book_mont(self.device)
            vals.append(book[torch.as_tensor(codes, device=self.device)])

        self.num_mem_cells = 1 << max(num_vars_x, num_vars_y)
        self.row = AddrTimestamps(self.num_mem_cells, N, ops_row)
        self.col = AddrTimestamps(self.num_mem_cells, N, ops_col)
        self.val = vals

        # comb_ops = row.addr x3, row.read_ts x3, col.addr x3, col.read_ts
        # x3, val x3, zero-padded to a power of two; comb_mem = the audit
        # timestamps of rows, then of columns
        ints = (self.row.ops_addr + self.row.read_ts + self.col.ops_addr
                + self.col.read_ts)
        mem = np.concatenate([self.row.audit_ts, self.col.audit_ts])
        self.comb_ops = _concat_padded(
            [small_ints_to_dev(a, self.device) for a in ints] + vals)
        self.comb_mem = DensePoly(small_ints_to_dev(mem, self.device))


class SparseMatPolyCommitmentGens:
    """reference sparse_mlpoly.rs:295-330."""

    def __init__(self, label: bytes, num_vars_x: int, num_vars_y: int,
                 num_nz_entries: int, batch_size: int = 3):
        num_vars_ops = _log2(_next_pow2(num_nz_entries)) + \
            _log2(_next_pow2(batch_size * 5))
        num_vars_mem = max(num_vars_x, num_vars_y) + 1
        num_vars_derefs = _log2(_next_pow2(num_nz_entries)) + \
            _log2(_next_pow2(batch_size * 2))
        self.gens_ops = PolyCommitmentGens(num_vars_ops, label)
        self.gens_mem = PolyCommitmentGens(num_vars_mem, label)
        self.gens_derefs = PolyCommitmentGens(num_vars_derefs, label)


@dataclass
class SparseMatPolyCommitment:
    batch_size: int
    num_ops: int
    num_mem_cells: int
    comm_comb_ops: PolyCommitment
    comm_comb_mem: PolyCommitment

    def append_to_transcript(self, _label: bytes, t: Transcript) -> None:
        t.append_message(b"batch_size", self.batch_size.to_bytes(8, "little"))
        t.append_message(b"num_ops", self.num_ops.to_bytes(8, "little"))
        t.append_message(b"num_mem_cells",
                         self.num_mem_cells.to_bytes(8, "little"))
        self.comm_comb_ops.append_to_transcript(b"comm_comb_ops", t)
        self.comm_comb_mem.append_to_transcript(b"comm_comb_mem", t)


def multi_commit(sparse_mats, num_vars_x: int, num_vars_y: int,
                 gens: SparseMatPolyCommitmentGens, device=None):
    """-> (commitment, dense decommitment) of a batch of sparse matrices."""
    dense = MultiSparseMatPolynomialAsDense(sparse_mats, num_vars_x,
                                            num_vars_y, device)
    comm_ops, _ = poly_commit(dense.comb_ops, gens.gens_ops, None)
    comm_mem, _ = poly_commit(dense.comb_mem, gens.gens_mem, None)
    return (SparseMatPolyCommitment(
        dense.batch_size, dense.N, dense.num_mem_cells, comm_ops, comm_mem),
        dense)


# ----------------------------------------------------------------------
# derefs
# ----------------------------------------------------------------------

class Derefs:
    """The memory values each op reads: eq(rx, row) and eq(ry, col)."""

    def __init__(self, row_ops_val, col_ops_val):
        self.row_ops_val = row_ops_val
        self.col_ops_val = col_ops_val
        self.comb = _concat_padded(list(row_ops_val) + list(col_ops_val))

    def commit(self, gens: PolyCommitmentGens) -> PolyCommitment:
        comm, _ = poly_commit(self.comb, gens, None)
        return comm


def derefs_commitment_append(comm: PolyCommitment, label: bytes,
                             t: Transcript) -> None:
    t.append_message(b"derefs_commitment", b"begin_derefs_commitment")
    comm.append_to_transcript(label, t)
    t.append_message(b"derefs_commitment", b"end_derefs_commitment")


def _bound_bot_ints(evals: List[int], challenges: List[int]) -> int:
    """Bind the low variables of a short host vector (joint claims)."""
    vals = [v % L for v in evals]
    for c in reversed(challenges):
        vals = [(vals[2 * i] + c * (vals[2 * i + 1] - vals[2 * i])) % L
                for i in range(len(vals) // 2)]
    if len(vals) != 1:
        raise ValueError("_bound_bot_ints: length is not 2^len(challenges)")
    return vals[0]


def _joint_claim(transcript: Transcript, label: bytes, evals: List[int],
                 challenge_label: bytes, joint_label: bytes):
    """Append the claimed evals, draw the combining challenges and append the
    joint claim: -> (joint eval, challenges)."""
    append_scalars_vector(transcript, label, evals)
    challenges = transcript.challenge_vector(challenge_label,
                                             _log2(len(evals)))
    joint = _bound_bot_ints(evals, challenges)
    transcript.append_scalar(joint_label, joint)
    return joint, list(challenges)


def _padded_evals(*groups) -> List[int]:
    evals = [v for g in groups for v in g]
    return evals + [0] * (_next_pow2(len(evals)) - len(evals))


@dataclass
class DerefsEvalProof:
    proof_derefs: PolyEvalProof

    PROTOCOL = b"Derefs evaluation proof"

    @staticmethod
    def prove(derefs: Derefs, eval_row: List[int], eval_col: List[int],
              r: Sequence[int], gens: PolyCommitmentGens,
              transcript: Transcript, tape: RandomTape) -> "DerefsEvalProof":
        transcript.append_protocol_name(DerefsEvalProof.PROTOCOL)
        evals = _padded_evals(eval_row, eval_col)
        if derefs.comb.num_vars != len(r) + _log2(len(evals)):
            raise InternalError("derefs: joint poly of the wrong size")
        joint, challenges = _joint_claim(
            transcript, b"evals_ops_val", evals, b"challenge_combine_n_to_one",
            b"joint_claim_eval")
        proof, _ = PolyEvalProof.prove(derefs.comb, None, challenges + list(r),
                                       joint, None, gens, transcript, tape)
        return DerefsEvalProof(proof)

    @verify_guard(failure=False)
    def verify(self, r: Sequence[int], eval_row: List[int],
               eval_col: List[int], gens: PolyCommitmentGens,
               comm: PolyCommitment, transcript: Transcript,
               acc=None) -> bool:
        transcript.append_protocol_name(DerefsEvalProof.PROTOCOL)
        evals = _padded_evals(eval_row, eval_col)
        joint, challenges = _joint_claim(
            transcript, b"evals_ops_val", evals, b"challenge_combine_n_to_one",
            b"joint_claim_eval")
        # the commitment to joint with a zero blind, deferred
        C_Zr = [(joint % L, (gens.gens.gens_1, 0))]
        return self.proof_derefs.verify(gens, transcript, challenges + list(r),
                                        C_Zr, comm, acc=acc)


# ----------------------------------------------------------------------
# hashed multiset layers
# ----------------------------------------------------------------------

class Layers:
    """Hashed leaves of the (init, read x3, write x3, audit) multisets of
    one address space: h(addr, val, ts) - r_multiset with
    h = ts r_hash^2 + val r_hash + addr."""

    def __init__(self, eval_table, addr_ts: AddrTimestamps,
                 ops_val, r_mem_check: Tuple[int, int]):
        r_hash, r_multiset = r_mem_check
        num_cells = eval_table.shape[0]
        dev = eval_table.device
        rh, rh2, rm = FQ.to_mont([r_hash, r_hash * r_hash % L, r_multiset],
                                 dev)

        def leaves(addr, val, ts):
            ts = small_ints_to_dev(ts, dev)
            h = FQ.add(FQ.add(FQ.mul(ts, rh2), FQ.mul(val, rh)),
                       small_ints_to_dev(addr, dev))
            return FQ.sub(h, rm)

        ident = np.arange(num_cells, dtype=np.int64)
        self.init_leaves = leaves(ident, eval_table, np.zeros_like(ident))
        self.audit_leaves = leaves(ident, eval_table, addr_ts.audit_ts)
        self.read_leaves = [leaves(a, v, t) for a, v, t in zip(
            addr_ts.ops_addr, ops_val, addr_ts.read_ts)]
        self.write_leaves = [leaves(a, v, t + 1) for a, v, t in zip(
            addr_ts.ops_addr, ops_val, addr_ts.read_ts)]


def _evaluate_many(polys, r: Sequence[int]) -> List[int]:
    """Each equal-length vector of ``polys`` evaluated at r (multilinear)."""
    chis = eq_evals(list(r), polys[0].device)
    return [int(v) for v in FQ.from_mont(FQ.dot(torch.stack(list(polys)),
                                                chis, axis=1))]


# ----------------------------------------------------------------------
# HashLayerProof
# ----------------------------------------------------------------------

@dataclass
class HashLayerProof:
    eval_row: Tuple[List[int], List[int], int]
    eval_col: Tuple[List[int], List[int], int]
    eval_val: List[int]
    eval_derefs: Tuple[List[int], List[int]]
    proof_ops: PolyEvalProof
    proof_mem: PolyEvalProof
    proof_derefs: DerefsEvalProof

    PROTOCOL = b"Sparse polynomial hash layer proof"

    @staticmethod
    def prove(rand: Tuple[List[int], List[int]],
              dense: MultiSparseMatPolynomialAsDense, derefs: Derefs,
              gens: SparseMatPolyCommitmentGens, transcript: Transcript,
              tape: RandomTape) -> "HashLayerProof":
        transcript.append_protocol_name(HashLayerProof.PROTOCOL)
        rand_mem, rand_ops = rand

        eval_row_ops_val = _evaluate_many(derefs.row_ops_val, rand_ops)
        eval_col_ops_val = _evaluate_many(derefs.col_ops_val, rand_ops)
        proof_derefs = DerefsEvalProof.prove(
            derefs, eval_row_ops_val, eval_col_ops_val, rand_ops,
            gens.gens_derefs, transcript, tape)

        def lift(vals):
            return small_ints_to_dev(vals, dense.device)

        def helper(ts: AddrTimestamps):
            addr = _evaluate_many([lift(a) for a in ts.ops_addr], rand_ops)
            rts = _evaluate_many([lift(t) for t in ts.read_ts], rand_ops)
            audit = _evaluate_many([lift(ts.audit_ts)], rand_mem)[0]
            return addr, rts, audit

        eval_row = helper(dense.row)
        eval_col = helper(dense.col)
        eval_val = _evaluate_many(dense.val, rand_ops)

        evals_ops = _padded_evals(eval_row[0], eval_row[1], eval_col[0],
                                  eval_col[1], eval_val)
        joint_ops, ch_ops = _joint_claim(
            transcript, b"claim_evals_ops", evals_ops,
            b"challenge_combine_n_to_one", b"joint_claim_eval_ops")
        proof_ops, _ = PolyEvalProof.prove(
            dense.comb_ops, None, ch_ops + list(rand_ops), joint_ops, None,
            gens.gens_ops, transcript, tape)

        evals_mem = [eval_row[2], eval_col[2]]
        joint_mem, ch_mem = _joint_claim(
            transcript, b"claim_evals_mem", evals_mem,
            b"challenge_combine_two_to_one", b"joint_claim_eval_mem")
        proof_mem, _ = PolyEvalProof.prove(
            dense.comb_mem, None, ch_mem + list(rand_mem), joint_mem, None,
            gens.gens_mem, transcript, tape)

        return HashLayerProof(eval_row, eval_col, eval_val,
                              (eval_row_ops_val, eval_col_ops_val),
                              proof_ops, proof_mem, proof_derefs)

    @staticmethod
    def _check_claims(rand_mem, claims, eval_ops_val, eval_ops_addr,
                      eval_read_ts, eval_audit_ts, r, r_hash,
                      r_multiset) -> bool:
        """The hash layer's claims against the product layer's."""
        rh2 = r_hash * r_hash % L

        def hashed(addr, val, ts):
            return (ts * rh2 + val * r_hash + addr - r_multiset) % L

        claim_init, claim_read, claim_write, claim_audit = claims
        # the identity poly and eq(r, .) at rand_mem
        init_addr = sum((1 << (len(rand_mem) - 1 - i)) * rand_mem[i]
                        for i in range(len(rand_mem))) % L
        init_val = eq_eval_single(list(r), list(rand_mem))
        if hashed(init_addr, init_val, 0) != claim_init % L:
            return False
        for i in range(len(eval_ops_addr)):
            if hashed(eval_ops_addr[i], eval_ops_val[i],
                      eval_read_ts[i]) != claim_read[i] % L:
                return False
            if hashed(eval_ops_addr[i], eval_ops_val[i],
                      eval_read_ts[i] + 1) != claim_write[i] % L:
                return False
        return hashed(init_addr, init_val, eval_audit_ts) == claim_audit % L

    @verify_guard(failure=False)
    def verify(self, rand, claims_row, claims_col, claims_dotp,
               comm: SparseMatPolyCommitment, gens: SparseMatPolyCommitmentGens,
               comm_derefs: PolyCommitment, rx, ry, r_hash, r_multiset,
               transcript: Transcript, acc=None) -> bool:
        transcript.append_protocol_name(HashLayerProof.PROTOCOL)
        rand_mem, rand_ops = rand

        eval_row_ops_val, eval_col_ops_val = self.eval_derefs
        if not self.proof_derefs.verify(rand_ops, eval_row_ops_val,
                                        eval_col_ops_val, gens.gens_derefs,
                                        comm_derefs, transcript, acc=acc):
            return False

        if len(claims_dotp) != 3 * len(eval_row_ops_val):
            return False
        for i in range(len(claims_dotp) // 3):
            if (claims_dotp[3 * i] % L != eval_row_ops_val[i] % L
                    or claims_dotp[3 * i + 1] % L != eval_col_ops_val[i] % L
                    or claims_dotp[3 * i + 2] % L != self.eval_val[i] % L):
                return False

        evals_ops = _padded_evals(self.eval_row[0], self.eval_row[1],
                                  self.eval_col[0], self.eval_col[1],
                                  self.eval_val)
        joint_ops, ch_ops = _joint_claim(
            transcript, b"claim_evals_ops", evals_ops,
            b"challenge_combine_n_to_one", b"joint_claim_eval_ops")
        C_ops = [(joint_ops % L, (gens.gens_ops.gens.gens_1, 0))]
        if not self.proof_ops.verify(gens.gens_ops, transcript,
                                     ch_ops + list(rand_ops), C_ops,
                                     comm.comm_comb_ops, acc=acc):
            return False

        evals_mem = [self.eval_row[2], self.eval_col[2]]
        joint_mem, ch_mem = _joint_claim(
            transcript, b"claim_evals_mem", evals_mem,
            b"challenge_combine_two_to_one", b"joint_claim_eval_mem")
        C_mem = [(joint_mem % L, (gens.gens_mem.gens.gens_1, 0))]
        if not self.proof_mem.verify(gens.gens_mem, transcript,
                                     ch_mem + list(rand_mem), C_mem,
                                     comm.comm_comb_mem, acc=acc):
            return False

        return (self._check_claims(rand_mem, claims_row, eval_row_ops_val,
                                   *self.eval_row, rx, r_hash, r_multiset)
                and self._check_claims(rand_mem, claims_col, eval_col_ops_val,
                                       *self.eval_col, ry, r_hash, r_multiset))


# ----------------------------------------------------------------------
# ProductLayerProof / PolyEvalNetworkProof / SparseMatPolyEvalProof
# ----------------------------------------------------------------------

def _prod(vals) -> int:
    out = 1
    for v in vals:
        out = out * v % L
    return out


def _multiset_ok(init, read, write, audit) -> bool:
    """init * prod(write) == prod(read) * audit."""
    return init * _prod(write) % L == _prod(read) * audit % L


def _append_space(t: Transcript, name: str, ev) -> None:
    init, read, write, audit = ev
    t.append_scalar(f"claim_{name}_eval_init".encode(), init)
    append_scalars_vector(t, f"claim_{name}_eval_read".encode(), read)
    append_scalars_vector(t, f"claim_{name}_eval_write".encode(), write)
    t.append_scalar(f"claim_{name}_eval_audit".encode(), audit)


@dataclass
class ProductLayerProof:
    eval_row: Tuple[int, List[int], List[int], int]
    eval_col: Tuple[int, List[int], List[int], int]
    eval_val: Tuple[List[int], List[int]]
    proof_mem: ProductCircuitEvalProofBatched
    proof_ops: ProductCircuitEvalProofBatched

    PROTOCOL = b"Sparse polynomial product layer proof"

    @staticmethod
    def prove(row_layers: Layers, col_layers: Layers,
              dense: MultiSparseMatPolynomialAsDense, derefs: Derefs,
              evals: List[int], transcript: Transcript):
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL)
        B = dense.batch_size

        ops_circ = BatchedProductCircuits(torch.stack(
            row_layers.read_leaves + row_layers.write_leaves
            + col_layers.read_leaves + col_layers.write_leaves))
        ops_evals = ops_circ.evaluate()
        mem_circ = BatchedProductCircuits(torch.stack(
            [row_layers.init_leaves, row_layers.audit_leaves,
             col_layers.init_leaves, col_layers.audit_leaves]))
        row_init, row_audit, col_init, col_audit = mem_circ.evaluate()
        eval_row = (row_init, ops_evals[0:B], ops_evals[B:2 * B], row_audit)
        eval_col = (col_init, ops_evals[2 * B:3 * B], ops_evals[3 * B:4 * B],
                    col_audit)

        for name, ev in (("row", eval_row), ("col", eval_col)):
            if not _multiset_ok(*ev):
                raise InternalError(f"{name} multiset check failed")
            _append_space(transcript, name, ev)

        # dot-product circuits: each instance's sum of row_val * col_val *
        # weight split into left and right halves, stacked interleaved
        # [left_0, right_0, left_1, right_1, ...] as in the reference
        half = dense.N // 2
        parts = ([], [], [])
        for i in range(B):
            for lo, hi in ((0, half), (half, 2 * half)):
                for part, vec in zip(parts, (derefs.row_ops_val[i],
                                             derefs.col_ops_val[i],
                                             dense.val[i])):
                    part.append(vec[lo:hi])
        dotp = BatchedDotProducts(*(torch.stack(p) for p in parts))
        dotp_evals = dotp.evaluate()
        lefts, rights = dotp_evals[0::2], dotp_evals[1::2]
        for i in range(B):
            transcript.append_scalar(b"claim_eval_dotp_left", lefts[i])
            transcript.append_scalar(b"claim_eval_dotp_right", rights[i])
            if (lefts[i] + rights[i]) % L != evals[i] % L:
                raise InternalError(f"dot product {i} does not sum to its "
                                    "claimed evaluation")

        proof_ops, rand_ops = ProductCircuitEvalProofBatched.prove(
            ops_circ, dotp, transcript)
        proof_mem, rand_mem = ProductCircuitEvalProofBatched.prove(
            mem_circ, None, transcript)
        return (ProductLayerProof(eval_row, eval_col, (lefts, rights),
                                  proof_mem, proof_ops), rand_mem, rand_ops)

    @verify_guard(failure=None)
    def verify(self, num_ops: int, num_cells: int, evals: List[int],
               transcript: Transcript):
        transcript.append_protocol_name(ProductLayerProof.PROTOCOL)
        for name, ev in (("row", self.eval_row), ("col", self.eval_col)):
            if not _multiset_ok(*ev):
                return None
            _append_space(transcript, name, ev)

        eval_dotp_left, eval_dotp_right = self.eval_val
        claims_dotp_circuit: List[int] = []
        for i in range(len(evals)):
            if (eval_dotp_left[i] + eval_dotp_right[i]) % L != evals[i] % L:
                return None
            transcript.append_scalar(b"claim_eval_dotp_left", eval_dotp_left[i])
            transcript.append_scalar(b"claim_eval_dotp_right",
                                     eval_dotp_right[i])
            claims_dotp_circuit += [eval_dotp_left[i], eval_dotp_right[i]]

        claims_prod_circuit = (list(self.eval_row[1]) + list(self.eval_row[2])
                               + list(self.eval_col[1])
                               + list(self.eval_col[2]))
        res_ops = self.proof_ops.verify(claims_prod_circuit,
                                        claims_dotp_circuit, num_ops,
                                        transcript)
        if res_ops is None:
            return None
        res_mem = self.proof_mem.verify(
            [self.eval_row[0], self.eval_row[3], self.eval_col[0],
             self.eval_col[3]], [], num_cells, transcript)
        if res_mem is None:
            return None
        claims_ops, claims_dotp, rand_ops = res_ops
        claims_mem, _, rand_mem = res_mem
        return claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops


@dataclass
class PolyEvalNetworkProof:
    proof_prod_layer: ProductLayerProof
    proof_hash_layer: HashLayerProof

    PROTOCOL = b"Sparse polynomial evaluation proof"

    @staticmethod
    def prove(dense, derefs, mem_rx, mem_ry, r_mem_check, evals, gens,
              transcript, tape):
        transcript.append_protocol_name(PolyEvalNetworkProof.PROTOCOL)
        row_layers = Layers(mem_rx, dense.row, derefs.row_ops_val, r_mem_check)
        col_layers = Layers(mem_ry, dense.col, derefs.col_ops_val, r_mem_check)
        proof_prod, rand_mem, rand_ops = ProductLayerProof.prove(
            row_layers, col_layers, dense, derefs, evals, transcript)
        proof_hash = HashLayerProof.prove((rand_mem, rand_ops), dense, derefs,
                                          gens, transcript, tape)
        return PolyEvalNetworkProof(proof_prod, proof_hash)

    @verify_guard(failure=False)
    def verify(self, comm, comm_derefs, evals, gens, rx, ry, r_mem_check,
               nz: int, transcript: Transcript, acc=None) -> bool:
        transcript.append_protocol_name(PolyEvalNetworkProof.PROTOCOL)
        r_hash, r_multiset = r_mem_check
        res = self.proof_prod_layer.verify(_next_pow2(nz), 1 << len(rx),
                                           evals, transcript)
        if res is None:
            return False
        claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops = res
        B = len(evals)
        if len(claims_mem) != 4 or len(claims_ops) != 4 * B:
            return False
        claims_row = (claims_mem[0], claims_ops[0:B], claims_ops[B:2 * B],
                      claims_mem[1])
        claims_col = (claims_mem[2], claims_ops[2 * B:3 * B],
                      claims_ops[3 * B:4 * B], claims_mem[3])
        return self.proof_hash_layer.verify(
            (rand_mem, rand_ops), claims_row, claims_col, claims_dotp,
            comm, gens, comm_derefs, rx, ry, r_hash, r_multiset, transcript,
            acc=acc)


def _equalize(rx: List[int], ry: List[int]):
    """Left-pad the shorter point with zeros (reference order)."""
    if len(rx) < len(ry):
        return [0] * (len(ry) - len(rx)) + list(rx), list(ry)
    if len(rx) > len(ry):
        return list(rx), [0] * (len(rx) - len(ry)) + list(ry)
    return list(rx), list(ry)


@dataclass
class SparseMatPolyEvalProof:
    comm_derefs: PolyCommitment
    poly_eval_network_proof: PolyEvalNetworkProof

    PROTOCOL = b"Sparse polynomial evaluation proof"

    @staticmethod
    def prove(dense: MultiSparseMatPolynomialAsDense, rx, ry, evals,
              gens: SparseMatPolyCommitmentGens, transcript: Transcript,
              tape: RandomTape) -> "SparseMatPolyEvalProof":
        transcript.append_protocol_name(SparseMatPolyEvalProof.PROTOCOL)
        if len(evals) != dense.batch_size:
            raise ValueError("one claimed evaluation per matrix")
        rx_ext, ry_ext = _equalize(rx, ry)
        mem_rx = eq_evals(rx_ext, dense.device)
        mem_ry = eq_evals(ry_ext, dense.device)
        derefs = Derefs(dense.row.deref(mem_rx), dense.col.deref(mem_ry))
        comm_derefs = derefs.commit(gens.gens_derefs)
        derefs_commitment_append(comm_derefs, b"comm_poly_row_col_ops_val",
                                 transcript)
        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        net_proof = PolyEvalNetworkProof.prove(
            dense, derefs, mem_rx, mem_ry, (r_mem_check[0], r_mem_check[1]),
            list(evals), gens, transcript, tape)
        return SparseMatPolyEvalProof(comm_derefs, net_proof)

    @verify_guard(failure=False)
    def verify(self, comm: SparseMatPolyCommitment, rx, ry, evals,
               gens: SparseMatPolyCommitmentGens,
               transcript: Transcript, acc=None) -> bool:
        transcript.append_protocol_name(SparseMatPolyEvalProof.PROTOCOL)
        rx_ext, ry_ext = _equalize(rx, ry)
        if (1 << len(rx_ext)) != comm.num_mem_cells:
            return False
        derefs_commitment_append(self.comm_derefs,
                                 b"comm_poly_row_col_ops_val", transcript)
        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        return self.poly_eval_network_proof.verify(
            comm, self.comm_derefs, list(evals), gens, rx_ext, ry_ext,
            (r_mem_check[0], r_mem_check[1]), comm.num_ops, transcript,
            acc=acc)


# ----------------------------------------------------------------------
# R1CS eval proof wrapper (reference r1csinstance.rs:324-374)
# ----------------------------------------------------------------------

@dataclass
class R1CSEvalProof:
    proof: SparseMatPolyEvalProof

    @staticmethod
    def prove(dense, rx, ry, evals, gens, transcript, tape) -> "R1CSEvalProof":
        return R1CSEvalProof(SparseMatPolyEvalProof.prove(
            dense, rx, ry, list(evals), gens, transcript, tape))

    @verify_guard(failure=False)
    def verify(self, comm, rx, ry, evals, gens, transcript, acc=None) -> bool:
        return self.proof.verify(comm, rx, ry, list(evals), gens, transcript,
                                 acc=acc)
