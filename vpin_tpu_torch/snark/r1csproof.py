"""R1CS satisfiability proof (two ZK sumchecks + Hyrax opening), stock and
with the vPIN commit-and-prove (CP) modifications.

Port of vpin_tpu/snark/r1csproof.py, bit for bit on the transcript:
  * my_R1CSProof_prove / my_r1csproof_verify
    (reference vPIN_proof_generation/src/commit_test.rs:136-496): the CP
    variant appends the externally-combined witness commitment and does
    NOT append `input`;
  * the stock R1CSProof::prove / verify (Spartan/src/r1csproof.rs:161-500),
    which appends `input` and commits the witness itself;
  * PolyEvalProof (reference Spartan/src/dense_mlpoly.rs:317-418);
  * gens derivation (reference Spartan/src/r1csproof.rs:49-91).
Table-sized prover work (multiply_vec, eq tables, sumcheck rounds, Hyrax
MSMs) runs on tensors when the tables are large; protocol scalars are exact
host ints.  The verifier runs on the host.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..batch_verify import VerifyAccumulator, combine_compress
from ..commit.pedersen import MultiCommitGens, hyrax_commit, hyrax_commit_host
from ..curve import host_ristretto as H
from ..curve.ristretto import RISTRETTO
from ..curve.rpoint import RPoint, decompress_many
from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..nizk.sigma import (
    DotProductProofLog, EqualityProof, KnowledgeProof, ProductProof,
    append_scalars_vector, dot_product_proof_gens,
)
from ..poly.dense import (DensePoly, dev_to_ints, eq_evals, eq_evals_host,
                          factored_lens, ints_to_dev)
from ..sumcheck.sumcheck import ZKSumcheckInstanceProof
from ..transcript.merlin import RandomTape, Transcript
from ..utils.errors import verify_guard
from ..utils.timer import span
from .r1cs import R1CSInstance

# ----------------------------------------------------------------------
# generators
# ----------------------------------------------------------------------

class PolyCommitmentGens:
    """reference: dense_mlpoly.rs PolyCommitmentGens::new."""

    def __init__(self, num_poly_vars: int, label: bytes):
        _, right = factored_lens(num_poly_vars)
        self.gens = dot_product_proof_gens(1 << right, label)


class R1CSSumcheckGens:
    def __init__(self, label: bytes, gens_1: MultiCommitGens):
        self.gens_1 = gens_1
        self.gens_3 = MultiCommitGens.new(3, label)
        self.gens_4 = MultiCommitGens.new(4, label)


class R1CSGens:
    def __init__(self, label: bytes, num_cons: int, num_vars: int):
        num_poly_vars = num_vars.bit_length() - 1
        self.gens_pc = PolyCommitmentGens(num_poly_vars, label)
        self.gens_sc = R1CSSumcheckGens(label, self.gens_pc.gens.gens_1)


# ----------------------------------------------------------------------
# PolyCommitment (Hyrax rows)
# ----------------------------------------------------------------------

@dataclass
class PolyCommitment:
    C: List[bytes]

    def append_to_transcript(self, label: bytes, t: Transcript) -> None:
        t.append_message(label, b"poly_commitment_begin")
        for c in self.C:
            t.append_point(b"poly_commitment_share", c)
        t.append_message(label, b"poly_commitment_end")


def _hyrax_rows(poly: DensePoly, blinds: List[int], gens_n) -> List[bytes]:
    """Hyrax row commitments -> compressed bytes; host ints for small
    polys, one batched table MSM (kernel K4) for large ones."""
    if poly.is_host:
        return [q.encode() for q in
                hyrax_commit_host(poly.Zh, blinds, gens_n)]
    rows = hyrax_commit(poly.Z, blinds, gens_n)
    return RISTRETTO.encode_bytes(rows)


def poly_commit(poly: DensePoly, gens_pc: PolyCommitmentGens,
                tape: Optional[RandomTape]) -> Tuple[PolyCommitment, List[int]]:
    """DensePolynomial::commit (dense_mlpoly.rs:193-218)."""
    ell = poly.num_vars
    lnv, rnv = factored_lens(ell)
    L_size = 1 << lnv
    blinds = (tape.random_vector(b"poly_blinds", L_size) if tape is not None
              else [0] * L_size)
    return PolyCommitment(_hyrax_rows(poly, blinds, gens_pc.gens.gens_n)), blinds


def combined_commit(poly: DensePoly, gens_pc: PolyCommitmentGens,
                    blind_1: List[int], blind_2: List[int]):
    """my_dense_mlpoly_commit: commit with blinds blind_1 + blind_2, so that
    C(w) = C(w_para) + C(w_input) (reference commit_test.rs:27-57)."""
    blinds = [(a + b) % L for a, b in zip(blind_1, blind_2)]
    return PolyCommitment(_hyrax_rows(poly, blinds, gens_pc.gens.gens_n)), blinds


# ----------------------------------------------------------------------
# PolyEvalProof
# ----------------------------------------------------------------------

@dataclass
class PolyEvalProof:
    proof: DotProductProofLog

    PROTOCOL = b"polynomial evaluation proof"

    @staticmethod
    def prove(poly: DensePoly, blinds: Optional[List[int]], r: Sequence[int],
              Zr: int, blind_Zr: Optional[int], gens: PolyCommitmentGens,
              transcript: Transcript, tape: RandomTape):
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL)
        if poly.num_vars != len(r):
            raise ValueError("PolyEvalProof: one point per variable")
        lnv, rnv = factored_lens(len(r))
        L_size, R_size = 1 << lnv, 1 << rnv
        blinds = blinds if blinds is not None else [0] * L_size
        blind_Zr = blind_Zr if blind_Zr is not None else 0

        L_vec = [x % L for x in _eq_half(r[:lnv])]
        R_vec = [x % L for x in _eq_half(r[lnv:])]

        device = None
        if poly.is_host:
            LZ = poly.bound_L(L_vec)
        else:
            device = poly.Z.device
            LZ = dev_to_ints(poly.bound_L(ints_to_dev(L_vec, device)))
        LZ_blind = sum(blinds[i] * L_vec[i] for i in range(L_size)) % L

        proof, _, C_Zr_prime = DotProductProofLog.prove(
            gens.gens, transcript, tape, LZ, LZ_blind, R_vec, Zr, blind_Zr,
            device=device)
        return PolyEvalProof(proof), C_Zr_prime

    @verify_guard(failure=False)
    def verify(self, gens: PolyCommitmentGens, transcript: Transcript,
               r: Sequence[int], C_Zr, comm: PolyCommitment,
               acc=None) -> bool:
        """C_Zr: compressed bytes or a deferred term list (for
        verifier-known committed values)."""
        local = acc is None
        if local:
            acc = VerifyAccumulator()
        transcript.append_protocol_name(PolyEvalProof.PROTOCOL)
        lnv, rnv = factored_lens(len(r))
        L_vec = _eq_half(r[:lnv])
        R_vec = _eq_half(r[lnv:])
        # C_LZ = sum_i L_vec[i] * C_i enters the transcript (as Cx)
        C_LZ = H.msm(L_vec, [p.h for p in decompress_many(comm.C)]).encode()
        ok = self.proof.verify(len(R_vec), gens.gens, transcript,
                               R_vec, C_LZ, C_Zr, acc=acc)
        if not ok:
            return False
        return acc.check() if local else True


@functools.lru_cache(maxsize=None)
def _eq_half_cached(r_tuple):
    return eq_evals_host(list(r_tuple))


def _eq_half(r: Sequence[int]) -> List[int]:
    return list(_eq_half_cached(tuple(int(x) for x in r)))


# ----------------------------------------------------------------------
# R1CSProof (CP variant)
# ----------------------------------------------------------------------

@dataclass
class R1CSProof:
    comm_vars: PolyCommitment
    sc_proof_phase1: ZKSumcheckInstanceProof
    claims_phase2: Tuple[bytes, bytes, bytes, bytes]
    pok_claims_phase2: Tuple[KnowledgeProof, ProductProof]
    proof_eq_sc_phase1: EqualityProof
    sc_proof_phase2: ZKSumcheckInstanceProof
    comm_vars_at_ry: bytes
    proof_eval_vars_at_ry: PolyEvalProof
    proof_eq_sc_phase2: EqualityProof

    PROTOCOL = b"Spartan R1CS proof"


def _log2(n: int) -> int:
    return n.bit_length() - 1


def r1cs_prove_cp(inst: R1CSInstance, vars_ints, inputs: List[int],
                  gens: R1CSGens, transcript: Transcript, tape: RandomTape,
                  poly_vars: DensePoly, comm_vars: PolyCommitment,
                  blinds_vars: List[int], ckpt=None):
    """my_R1CSProof_prove (commit_test.rs:136-334).  The CP deviation:
    the externally-combined commitment is appended and `input` is NOT.
    vars_ints: a host int list or a Montgomery tensor (num_vars, 8).
    ckpt: a CheckpointStore for the two sumchecks (keys sc1 and sc2)."""
    transcript.append_protocol_name(R1CSProof.PROTOCOL)
    if len(inputs) >= _alen(vars_ints):
        raise ValueError("r1cs_prove_cp: more inputs than variables")
    comm_vars.append_to_transcript(b"poly_commitment", transcript)
    return _r1cs_prove_core(inst, vars_ints, inputs, gens, transcript, tape,
                            poly_vars, comm_vars, blinds_vars, ckpt=ckpt)


def r1cs_prove_stock(inst: R1CSInstance, vars_ints, inputs: List[int],
                     gens: R1CSGens, transcript: Transcript,
                     tape: RandomTape):
    """Stock R1CSProof::prove (r1csproof.rs:161-366): appends `input` and
    commits the witness itself with the proof tape."""
    transcript.append_protocol_name(R1CSProof.PROTOCOL)
    if len(inputs) >= _alen(vars_ints):
        raise ValueError("r1cs_prove_stock: more inputs than variables")
    append_scalars_vector(transcript, b"input", inputs)
    poly_vars = (DensePoly(vars_ints) if isinstance(vars_ints, torch.Tensor)
                 else DensePoly.from_ints(vars_ints, inst.device))
    comm_vars, blinds_vars = poly_commit(poly_vars, gens.gens_pc, tape)
    comm_vars.append_to_transcript(b"poly_commitment", transcript)
    return _r1cs_prove_core(inst, vars_ints, inputs, gens, transcript, tape,
                            poly_vars, comm_vars, blinds_vars)


def _alen(vals) -> int:
    return vals.shape[0] if isinstance(vals, torch.Tensor) else len(vals)


def _r1cs_prove_core(inst, vars_ints, inputs, gens, transcript, tape,
                     poly_vars, comm_vars, blinds_vars, ckpt=None):
    num_vars = _alen(vars_ints)
    host = inst.host_mode and not isinstance(vars_ints, torch.Tensor)
    if isinstance(vars_ints, torch.Tensor):
        dev = vars_ints.device
        tail = ints_to_dev([1] + list(inputs), dev)
        pad = FQ.zeros((num_vars - len(inputs) - 1,), dev)
        z = torch.cat([vars_ints, tail, pad])
    else:
        z_ints = [int(v) % L for v in vars_ints] + [1] + \
            [int(v) % L for v in inputs] + \
            [0] * (num_vars - len(inputs) - 1)
        z = z_ints if host else ints_to_dev(z_ints, inst.device)
    dev = None if host else z.device

    num_rounds_x = _log2(inst.num_cons)
    num_rounds_y = _log2(2 * num_vars)
    tau = transcript.challenge_vector(b"challenge_tau", num_rounds_x)

    poly_tau = DensePoly(eq_evals_host(tau)) if host \
        else DensePoly(eq_evals(tau, dev))
    poly_Az, poly_Bz, poly_Cz = inst.multiply_vec(z)

    with span("prove_sc_phase_one"):
        sc_proof_phase1, rx, claims_phase1, blind_claim_postsc1 = \
            ZKSumcheckInstanceProof.prove_cubic_with_additive_term(
                0, 0, num_rounds_x, poly_tau, poly_Az, poly_Bz, poly_Cz,
                gens.gens_sc.gens_1, gens.gens_sc.gens_4, transcript, tape,
                ckpt=ckpt, ckpt_key="sc1")
    tau_claim, Az_claim, Bz_claim, Cz_claim = claims_phase1

    Az_blind = tape.random_scalar(b"Az_blind")
    Bz_blind = tape.random_scalar(b"Bz_blind")
    Cz_blind = tape.random_scalar(b"Cz_blind")
    prod_Az_Bz_blind = tape.random_scalar(b"prod_Az_Bz_blind")

    pok_Cz_claim, comm_Cz_claim = KnowledgeProof.prove(
        gens.gens_sc.gens_1, transcript, tape, Cz_claim, Cz_blind)
    prod = Az_claim * Bz_claim % L
    proof_prod, comm_Az_claim, comm_Bz_claim, comm_prod_Az_Bz_claims = \
        ProductProof.prove(gens.gens_sc.gens_1, transcript, tape,
                           Az_claim, Az_blind, Bz_claim, Bz_blind,
                           prod, prod_Az_Bz_blind)

    transcript.append_point(b"comm_Az_claim", comm_Az_claim)
    transcript.append_point(b"comm_Bz_claim", comm_Bz_claim)
    transcript.append_point(b"comm_Cz_claim", comm_Cz_claim)
    transcript.append_point(b"comm_prod_Az_Bz_claims", comm_prod_Az_Bz_claims)

    taus_bound_rx = tau_claim
    blind_expected_claim_postsc1 = taus_bound_rx * (prod_Az_Bz_blind - Cz_blind) % L
    claim_post_phase1 = (Az_claim * Bz_claim - Cz_claim) * taus_bound_rx % L
    proof_eq_sc_phase1, _, _ = EqualityProof.prove(
        gens.gens_sc.gens_1, transcript, tape,
        claim_post_phase1, blind_expected_claim_postsc1,
        claim_post_phase1, blind_claim_postsc1)

    r_A = transcript.challenge_scalar(b"challenege_Az")
    r_B = transcript.challenge_scalar(b"challenege_Bz")
    r_C = transcript.challenge_scalar(b"challenege_Cz")
    claim_phase2 = (r_A * Az_claim + r_B * Bz_claim + r_C * Cz_claim) % L
    blind_claim_phase2 = (r_A * Az_blind + r_B * Bz_blind + r_C * Cz_blind) % L

    if host:
        evals_rx = eq_evals_host(rx)
        evals_A, evals_B, evals_C = inst.compute_eval_table_sparse(evals_rx)
        evals_ABC = [(r_A * a + r_B * b + r_C * c) % L
                     for a, b, c in zip(evals_A, evals_B, evals_C)]
        poly_z2, poly_abc = DensePoly(z), DensePoly(evals_ABC)
    else:
        evals_rx = eq_evals(rx, dev)
        evals_A, evals_B, evals_C = inst.compute_eval_table_sparse(evals_rx)
        rA_d, rB_d, rC_d = FQ.to_mont([r_A, r_B, r_C], dev)
        evals_ABC = FQ.add(FQ.add(FQ.mul(rA_d, evals_A),
                                  FQ.mul(rB_d, evals_B)),
                           FQ.mul(rC_d, evals_C))
        poly_z2, poly_abc = DensePoly(z), DensePoly(evals_ABC)

    with span("prove_sc_phase_two"):
        sc_proof_phase2, ry, claims_phase2_vals, blind_claim_postsc2 = \
            ZKSumcheckInstanceProof.prove_quad(
                claim_phase2, blind_claim_phase2, num_rounds_y,
                poly_z2, poly_abc,
                gens.gens_sc.gens_1, gens.gens_sc.gens_3, transcript, tape,
                ckpt=ckpt, ckpt_key="sc2")

    eval_vars_at_ry = poly_vars.evaluate(ry[1:])
    blind_eval = tape.random_scalar(b"blind_eval")
    with span("polyeval"):
        proof_eval_vars_at_ry, comm_vars_at_ry = PolyEvalProof.prove(
            poly_vars, blinds_vars, ry[1:], eval_vars_at_ry, blind_eval,
            gens.gens_pc, transcript, tape)

    blind_eval_Z_at_ry = (1 - ry[0]) * blind_eval % L
    blind_expected_claim_postsc2 = claims_phase2_vals[1] * blind_eval_Z_at_ry % L
    claim_post_phase2 = claims_phase2_vals[0] * claims_phase2_vals[1] % L
    proof_eq_sc_phase2, _, _ = EqualityProof.prove(
        gens.gens_pc.gens.gens_1, transcript, tape,
        claim_post_phase2, blind_expected_claim_postsc2,
        claim_post_phase2, blind_claim_postsc2)

    return (R1CSProof(
        comm_vars, sc_proof_phase1,
        (comm_Az_claim, comm_Bz_claim, comm_Cz_claim, comm_prod_Az_Bz_claims),
        (pok_Cz_claim, proof_prod), proof_eq_sc_phase1, sc_proof_phase2,
        comm_vars_at_ry, proof_eval_vars_at_ry, proof_eq_sc_phase2), rx, ry)


@verify_guard(failure=None)
def r1cs_verify_cp(proof: R1CSProof, num_vars: int, num_cons: int,
                   inputs: List[int], evals: Tuple[int, int, int],
                   transcript: Transcript, gens: R1CSGens,
                   comm_1: PolyCommitment, comm_2: PolyCommitment,
                   acc=None):
    """my_r1csproof_verify (commit_test.rs:340-496).  Returns (rx, ry) or
    None on failure."""
    transcript.append_protocol_name(R1CSProof.PROTOCOL)

    if len(comm_2.C) != len(comm_1.C):
        return None
    a = [H.decode(bytes(x)) for x in comm_1.C]
    b = [H.decode(bytes(x)) for x in comm_2.C]
    combined = PolyCommitment([(p + q).encode() for p, q in zip(a, b)])
    combined.append_to_transcript(b"poly_commitment", transcript)
    return _r1cs_verify_core(proof, num_vars, num_cons, inputs, evals,
                             transcript, gens, combined, acc=acc)


@verify_guard(failure=None)
def r1cs_verify_stock(proof: R1CSProof, num_vars: int, num_cons: int,
                      inputs: List[int], evals: Tuple[int, int, int],
                      transcript: Transcript, gens: R1CSGens, acc=None):
    """Stock R1CSProof::verify (r1csproof.rs:368-500).  Returns (rx, ry) or
    None on failure."""
    transcript.append_protocol_name(R1CSProof.PROTOCOL)
    append_scalars_vector(transcript, b"input", inputs)
    proof.comm_vars.append_to_transcript(b"poly_commitment", transcript)
    return _r1cs_verify_core(proof, num_vars, num_cons, inputs, evals,
                             transcript, gens, proof.comm_vars, acc=acc)


IDENTITY_BYTES = bytes(32)      # compressed ristretto identity


def _r1cs_verify_core(proof, num_vars, num_cons, inputs, evals, transcript,
                      gens, comm_for_eval, acc=None):
    local = acc is None
    if local:
        acc = VerifyAccumulator()
    num_rounds_x = _log2(num_cons)
    num_rounds_y = _log2(2 * num_vars)
    tau = transcript.challenge_vector(b"challenge_tau", num_rounds_x)

    # commit1(0, 0) is the identity point
    claim_phase1 = IDENTITY_BYTES
    res1 = proof.sc_proof_phase1.verify(
        claim_phase1, num_rounds_x, 3, gens.gens_sc.gens_1,
        gens.gens_sc.gens_4, transcript, acc=acc)
    if res1 is None:
        return None
    comm_claim_post_phase1, rx = res1

    comm_Az_claim, comm_Bz_claim, comm_Cz_claim, comm_prod_Az_Bz_claims = \
        proof.claims_phase2
    pok_Cz_claim, proof_prod = proof.pok_claims_phase2
    if not pok_Cz_claim.verify(gens.gens_sc.gens_1, transcript,
                               comm_Cz_claim, acc=acc):
        return None
    if not proof_prod.verify(gens.gens_sc.gens_1, transcript, comm_Az_claim,
                             comm_Bz_claim, comm_prod_Az_Bz_claims, acc=acc):
        return None

    transcript.append_point(b"comm_Az_claim", comm_Az_claim)
    transcript.append_point(b"comm_Bz_claim", comm_Bz_claim)
    transcript.append_point(b"comm_Cz_claim", comm_Cz_claim)
    transcript.append_point(b"comm_prod_Az_Bz_claims", comm_prod_Az_Bz_claims)

    # one batched decode of the four claim points
    claim_pts = decompress_many([comm_Az_claim, comm_Bz_claim,
                                 comm_Cz_claim, comm_prod_Az_Bz_claims])

    taus_bound_rx = 1
    for i in range(len(rx)):
        taus_bound_rx = taus_bound_rx * (
            rx[i] * tau[i] + (1 - rx[i]) * (1 - tau[i])) % L
    expected_claim_post_phase1 = combine_compress(
        [claim_pts[3], claim_pts[2]],
        [taus_bound_rx, (L - taus_bound_rx) % L])

    if not proof.proof_eq_sc_phase1.verify(
            gens.gens_sc.gens_1, transcript,
            expected_claim_post_phase1, comm_claim_post_phase1, acc=acc):
        return None

    r_A = transcript.challenge_scalar(b"challenege_Az")
    r_B = transcript.challenge_scalar(b"challenege_Bz")
    r_C = transcript.challenge_scalar(b"challenege_Cz")
    comm_claim_phase2 = combine_compress(claim_pts[:3], [r_A, r_B, r_C])

    res2 = proof.sc_proof_phase2.verify(
        comm_claim_phase2, num_rounds_y, 2, gens.gens_sc.gens_1,
        gens.gens_sc.gens_3, transcript, acc=acc)
    if res2 is None:
        return None
    comm_claim_post_phase2, ry = res2

    if not proof.proof_eval_vars_at_ry.verify(
            gens.gens_pc, transcript, ry[1:], proof.comm_vars_at_ry,
            comm_for_eval, acc=acc):
        return None

    # poly_input_eval: sparse poly [1, inputs...] evaluated at ry[1:]
    poly_input_eval = _sparse_poly_eval(
        [1] + list(inputs), _log2(num_vars), ry[1:])

    eval_A_r, eval_B_r, eval_C_r = evals
    scalar = (r_A * eval_A_r + r_B * eval_B_r + r_C * eval_C_r) % L
    g1 = gens.gens_pc.gens.gens_1
    expected_claim_post_phase2 = combine_compress(
        [RPoint.decompress(proof.comm_vars_at_ry), g1.G_point(0)],
        [(1 - ry[0]) * scalar % L, ry[0] * poly_input_eval * scalar % L])
    if not proof.proof_eq_sc_phase2.verify(
            g1, transcript,
            expected_claim_post_phase2, comm_claim_post_phase2, acc=acc):
        return None

    if local and not acc.check():
        return None
    return rx, ry


def _sparse_poly_eval(entries: List[int], num_vars: int, r: Sequence[int]) -> int:
    """SparsePolynomial::evaluate over entries at indices 0..len-1
    (reference: sparse_mlpoly.rs:1574-1622)."""
    total = 0
    for idx, val in enumerate(entries):
        chi = 1
        for j in range(num_vars):
            bit = (idx >> (num_vars - 1 - j)) & 1
            chi = chi * (r[j] if bit else (1 - r[j])) % L
        total = (total + chi * val) % L
    return total
