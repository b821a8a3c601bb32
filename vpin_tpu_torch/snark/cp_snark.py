"""Commit-and-prove Spartan SNARK (the vPIN L2 flow).

Port of vpin_tpu/snark/cp_snark.py (reference
vPIN_proof_generation/src/proof_point_add.rs:23-113 and commit_test.rs
my_lib_prove / my_lib_verify):
  1. commit vars_para and vars_input separately with one RandomTape;
  2. combine the commitments homomorphically (C = C_para + C_input);
  3. sat proof over the combined commitment (CP transcript semantics);
  4. append the Ar/Br/Cr claims, then, in the full SNARK, prove them with
     the R1CS eval proof (SPARK) over the matrices' commitment from
     ``snark_encode``.
In transparent mode (``with_eval_proof=False``) the verifier evaluates the
public R1CS matrices itself.  The verifier runs on the host whatever the
instance's size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..batch_verify import VerifyAccumulator
from ..curve import host_ristretto as H
from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..poly.dense import DensePoly, factored_lens
# a module reference: spark/sparse_mlpoly.py imports snark/r1csproof.py, so
# either package may be the one imported first
from ..spark import sparse_mlpoly as spark
from ..transcript.merlin import RandomTape, Transcript
from ..utils.errors import verify_guard
from ..utils.timer import Timer, span
from .r1cs import R1CSInstance
from .r1csproof import (
    PolyCommitment, R1CSGens, R1CSProof, poly_commit, r1cs_prove_cp,
    r1cs_verify_cp,
)

SNARK_PROTOCOL = b"Spartan SNARK proof"


def snark_encode(inst: R1CSInstance, gens: "SNARKGens"):
    """SNARK::encode: commit to the R1CS matrices (reference lib.rs:340-358)
    on the instance's device.  Returns (SparseMatPolyCommitment, dense
    decommitment)."""
    num_poly_vars_x = inst.num_cons.bit_length() - 1
    num_poly_vars_y = (2 * inst.num_vars).bit_length() - 1
    with span("SNARK::encode"):
        return spark.multi_commit([inst.A, inst.B, inst.C], num_poly_vars_x,
                                  num_poly_vars_y, gens.gens_r1cs_eval,
                                  device=inst.device)


def _ceil_log2(n: int) -> int:
    return (n - 1).bit_length() if n > 1 else 0


class SNARKGens:
    """reference: lib.rs:295-327; the eval-proof generators are derived on
    first use."""

    def __init__(self, num_cons: int, num_vars: int, num_inputs: int,
                 num_nz_entries: int):
        num_vars_padded = max(num_vars, num_inputs + 1)
        if num_vars_padded & (num_vars_padded - 1):
            num_vars_padded = 1 << num_vars_padded.bit_length()
        self.num_vars_padded = num_vars_padded
        self.num_cons = num_cons
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons, num_vars_padded)
        self.num_nz_entries = num_nz_entries
        self._gens_r1cs_eval = None

    @property
    def gens_r1cs_eval(self) -> "spark.SparseMatPolyCommitmentGens":
        if self._gens_r1cs_eval is None:
            # reference R1CSCommitmentGens::new (r1csinstance.rs:33-49)
            self._gens_r1cs_eval = spark.SparseMatPolyCommitmentGens(
                b"gens_r1cs_eval", _ceil_log2(max(self.num_cons, 2)),
                _ceil_log2(2 * self.num_vars_padded), self.num_nz_entries,
                batch_size=3)
        return self._gens_r1cs_eval


@dataclass
class CPSnarkProof:
    r1cs_sat_proof: R1CSProof
    inst_evals: Tuple[int, int, int]
    r1cs_eval_proof: Optional["spark.R1CSEvalProof"] = None

    def size(self) -> int:
        """Serialized byte count (the reference measures proof size as
        bincode::serialize(...).len(), proof_point_add.rs:96-98)."""
        from ..utils.bincode import serialize_snark
        return len(serialize_snark(self))


def pad_assignment(vals, n: int):
    """Zero-pad a host int list OR a Montgomery tensor to length n."""
    if isinstance(vals, torch.Tensor):
        if vals.shape[0] > n:
            raise ValueError("pad_assignment: assignment longer than n")
        if vals.shape[0] == n:
            return vals
        return torch.cat([vals, FQ.zeros((n - vals.shape[0],), vals.device)])
    if len(vals) > n:
        raise ValueError("pad_assignment: assignment longer than n")
    return list(vals) + [0] * (n - len(vals))


def _assignment_poly(vals, n: int, device) -> DensePoly:
    padded = pad_assignment(vals, n)
    if isinstance(padded, torch.Tensor):
        return DensePoly(padded)
    return DensePoly.from_ints(padded, device)


def _sparse_entries(vals, max_frac=1 / 64):
    """[(index, value)] when vals is sparse enough for the sparse Hyrax
    path, else None.  Takes host int lists and Montgomery tensors."""
    if isinstance(vals, torch.Tensor):
        idx = torch.nonzero((vals != 0).any(-1)).reshape(-1)
        if len(idx) > max(1, int(vals.shape[0] * max_frac)):
            return None
        if len(idx) == 0:
            return []
        vs = [int(v) for v in FQ.from_mont(vals[idx])]
        return list(zip(idx.tolist(), vs))
    idx = [i for i, v in enumerate(vals) if int(v) % L]
    if len(idx) > max(1, int(len(vals) * max_frac)):
        return None
    return [(i, int(vals[i]) % L) for i in idx]


def _hyrax_commit_sparse(n: int, entries, gens_pc, tape):
    """Hyrax row commitments of a sparse assignment: row i commits as
    blind_i*h + its few value*G terms, in host point arithmetic.  Blind
    draws match poly_commit exactly (same tape labels and order), so the
    bytes equal the dense path's."""
    ell = n.bit_length() - 1
    lnv, rnv = factored_lens(ell)
    L_size, R_size = 1 << lnv, 1 << rnv
    blinds = tape.random_vector(b"poly_blinds", L_size)
    gens_n = gens_pc.gens.gens_n
    per_row = {}
    for i, v in entries:
        per_row.setdefault(i // R_size, []).append((i % R_size, v))
    rows = []
    for r in range(L_size):
        scalars = [blinds[r]]
        pts = [gens_n.hh]
        for c, v in per_row.get(r, ()):
            scalars.append(v)
            pts.append(gens_n.Gh[c])
        rows.append(H.msm(scalars, pts).encode())
    return PolyCommitment(rows), blinds


def cp_commit_witness(vars_para, vars_input, full_vars, gens: SNARKGens,
                      tape_seed: Optional[int] = None, device=None,
                      ckpt=None):
    """Commit the two witness shares and the combined witness (reference
    proof_point_add.rs:44-78).  Host int lists become tensors on
    ``device`` when they are longer than HOST_POLY_MAX.

    With a CheckpointStore the row commitments are saved under
    ``witness_commit``; on resume they load from it and the blinds are drawn
    again from the seeded tape: twice ``poly_blinds`` of L_size, exactly
    the draws of the sparse and the dense Hyrax paths."""
    n = gens.num_vars_padded
    tape1 = RandomTape(bytes([2]), seed=tape_seed)

    cached = ckpt.load("witness_commit") if ckpt is not None else None
    if cached is not None:
        if tape_seed is None:
            raise ValueError("a checkpoint resume needs tape_seed")
        L_size = 1 << factored_lens(n.bit_length() - 1)[0]
        blind_para = tape1.random_vector(b"poly_blinds", L_size)
        blind_input = tape1.random_vector(b"poly_blinds", L_size)
        blind_vars = [(a + b) % L for a, b in zip(blind_para, blind_input)]
        poly_vars = _assignment_poly(full_vars, n, device)
        return (poly_vars, PolyCommitment(cached["vars"]), blind_vars,
                PolyCommitment(cached["para"]),
                PolyCommitment(cached["input"]))

    gens_pc = gens.gens_r1cs_sat.gens_pc
    sparse_para = _sparse_entries(vars_para)
    if sparse_para is not None:
        # vars_para is the scalars-only share: all-zero for point-add, one
        # entry per mult for point-mult (reference point_mult.rs:517)
        comm_para, blind_para = _hyrax_commit_sparse(
            n, sparse_para, gens_pc, tape1)
    else:
        poly_para = _assignment_poly(vars_para, n, device)
        comm_para, blind_para = poly_commit(poly_para, gens_pc, tape1)
    poly_input = _assignment_poly(vars_input, n, device)
    comm_input, blind_input = poly_commit(poly_input, gens_pc, tape1)

    # the combined commitment with blinds blind_para + blind_input is, by
    # the Pedersen homomorphism, C_para[i] + C_input[i] row by row (what the
    # reference asserts after recommitting, proof_point_add.rs:69-78)
    poly_vars = _assignment_poly(full_vars, n, device)
    blind_vars = [(a + b) % L for a, b in zip(blind_para, blind_input)]
    pa = [H.decode(bytes(b)) for b in comm_para.C]
    pi = [H.decode(bytes(b)) for b in comm_input.C]
    comm_vars = PolyCommitment([(a + b).encode() for a, b in zip(pa, pi)])
    if ckpt is not None:
        ckpt.save("witness_commit", {"para": list(comm_para.C),
                                     "input": list(comm_input.C),
                                     "vars": list(comm_vars.C)})
    return (poly_vars, comm_vars, blind_vars, comm_para, comm_input)


def cp_snark_prove(inst: R1CSInstance, full_vars, inputs: List[int],
                   gens: SNARKGens, transcript: Transcript,
                   poly_vars: DensePoly, comm_vars: PolyCommitment,
                   blind_vars: List[int], decomm=None,
                   tape_seed: Optional[int] = None,
                   with_eval_proof: bool = False, ckpt=None) -> CPSnarkProof:
    """my_lib_prove (commit_test.rs:59-133).  The full SNARK
    (``with_eval_proof``) takes ``decomm``, the dense matrices from
    ``snark_encode``.  With a CheckpointStore the sumchecks save their
    rounds, and the finished sat proof is saved under ``post_sat``; a resume
    past it goes straight to the eval proof."""
    if with_eval_proof and decomm is None:
        raise ValueError("the eval proof needs snark_encode's decommitment")
    t_all = Timer("SNARK::prove")
    tape = RandomTape(b"proof", seed=tape_seed)
    transcript.append_protocol_name(SNARK_PROTOCOL)

    post_sat = ckpt.load("post_sat") if ckpt is not None else None
    if post_sat is not None:
        if tape_seed is None:
            raise ValueError("a checkpoint resume needs tape_seed")
        transcript.restore(post_sat["transcript"])
        tape.restore(post_sat["tape"])
        sat_proof = post_sat["sat_proof"]
        rx, ry = post_sat["rx"], post_sat["ry"]
        Ar, Br, Cr = post_sat["evals"]
    else:
        padded_vars = pad_assignment(full_vars, gens.num_vars_padded)
        with span("R1CSProof::prove"):
            sat_proof, rx, ry = r1cs_prove_cp(
                inst, padded_vars, inputs, gens.gens_r1cs_sat, transcript,
                tape, poly_vars, comm_vars, blind_vars, ckpt=ckpt)

        with span("eval_sparse_polys"):
            Ar, Br, Cr = inst.evaluate(rx, ry)
        transcript.append_scalar(b"Ar_claim", Ar)
        transcript.append_scalar(b"Br_claim", Br)
        transcript.append_scalar(b"Cr_claim", Cr)
        if ckpt is not None:
            ckpt.save("post_sat", {
                "transcript": transcript.snapshot(), "tape": tape.snapshot(),
                "sat_proof": sat_proof, "rx": rx, "ry": ry,
                "evals": (Ar, Br, Cr)})

    eval_proof = None
    if with_eval_proof:
        with span("R1CSEvalProof::prove"):
            eval_proof = spark.R1CSEvalProof.prove(
                decomm, rx, ry, (Ar, Br, Cr), gens.gens_r1cs_eval,
                transcript, tape)
    t_all.stop()
    return CPSnarkProof(sat_proof, (Ar, Br, Cr), eval_proof)


@verify_guard(failure=False)
def cp_snark_verify(proof: CPSnarkProof, inst: R1CSInstance, inputs: List[int],
                    transcript: Transcript, gens: SNARKGens,
                    comm_para: PolyCommitment, comm_input: PolyCommitment,
                    comm=None) -> bool:
    """my_lib_verify (commit_test.rs:498-544).  With ``comm`` (the
    matrices' commitment from ``snark_encode``) the proof must carry the
    eval proof, which is checked against it; without, the proof must be
    transparent and the verifier evaluates the public matrices on the host.
    All group equations defer into one batched final check."""
    if (comm is None) != (proof.r1cs_eval_proof is None):
        return False
    acc = VerifyAccumulator()
    transcript.append_protocol_name(SNARK_PROTOCOL)

    res = r1cs_verify_cp(
        proof.r1cs_sat_proof, gens.num_vars_padded, inst.num_cons,
        inputs, proof.inst_evals, transcript, gens.gens_r1cs_sat,
        comm_para, comm_input, acc=acc)
    if res is None:
        return False
    rx, ry = res

    Ar, Br, Cr = proof.inst_evals
    transcript.append_scalar(b"Ar_claim", Ar)
    transcript.append_scalar(b"Br_claim", Br)
    transcript.append_scalar(b"Cr_claim", Cr)

    if comm is not None:
        if not proof.r1cs_eval_proof.verify(
                comm, rx, ry, proof.inst_evals, gens.gens_r1cs_eval,
                transcript, acc=acc):
            return False
    else:
        got = inst.evaluate_host(rx, ry)
        if tuple(x % L for x in got) != tuple(x % L for x in proof.inst_evals):
            return False
    return acc.check()
