"""Batched grand-product and dot-product circuits (SPARK's GKR-style layer).

Port of vpin_tpu/spark/product_tree.py (reference Spartan product_tree.rs),
bit for bit on the transcript (ProductCircuitEvalProofBatched::prove/verify,
SumcheckInstanceProof::prove_cubic_batched).  Same-shape circuits are held
stacked, so each tree layer, each round's evaluation sums and each bind is
one batched expression over all K circuits.  The stacks are (K, len, 8)
Montgomery limbs; every field product is kernel K1, and each round slices
the live halves directly (the reference's masked fixed-shape kernels only
bounded XLA compiles; field values are canonical, so the bytes are the
same).  Unlike vpin_tpu, small instances do not move to host ints: on the
H100 the 16-add proof's SPARK is as fast on tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..poly.dense import eq_evals
from ..sumcheck.sumcheck import (SumcheckInstanceProof, UniPoly, bind_tables,
                                 round_sums)
from ..transcript.merlin import Transcript
from ..utils.errors import InternalError, verify_guard


def _ints(t: torch.Tensor) -> List[int]:
    return [int(v) for v in FQ.from_mont(t).reshape(-1)]


class BatchedProductCircuits:
    """K product circuits over equal-length inputs, layers stacked."""

    def __init__(self, inputs):
        """inputs: (K, n, 8) Montgomery tensor of hashed leaf values, n a
        power of two."""
        K, n = inputs.shape[0], inputs.shape[1]
        self.K, self.n = K, n
        self.left_layers: List = [inputs[:, : n // 2]]
        self.right_layers: List = [inputs[:, n // 2:]]
        for _ in range(n.bit_length() - 2):
            prod = FQ.mul(self.left_layers[-1], self.right_layers[-1])
            half = prod.shape[1] // 2
            self.left_layers.append(prod[:, :half])
            self.right_layers.append(prod[:, half:])

    def evaluate(self) -> List[int]:
        return _ints(FQ.mul(self.left_layers[-1][:, 0],
                            self.right_layers[-1][:, 0]))


@dataclass
class BatchedDotProducts:
    """K2 dot-product circuits (left * right * weight summed), stacked."""
    left: torch.Tensor      # (K2, m, 8) Montgomery limbs
    right: torch.Tensor
    weight: torch.Tensor

    def evaluate(self) -> List[int]:
        s = FQ.sum_reduce(FQ.mul(FQ.mul(self.left, self.right), self.weight),
                          axis=1)
        return _ints(s)

    @property
    def k(self) -> int:
        return self.left.shape[0]


class _Tables:
    """The (A, B, C) stacks one batched cubic sumcheck binds: round
    evaluations and binds over all circuits at once."""

    def __init__(self, A, B, C):
        self.t = [A, B, C]

    def round_evals(self) -> List[List[int]]:
        sums = FQ.from_mont(round_sums("cubic", self.t))      # (3, K)
        return [[int(v) for v in row] for row in sums]

    def bind(self, r: int) -> None:
        self.t = bind_tables(self.t, r)

    def heads(self, k: int = 3) -> List[List[int]]:
        """The first k tables' bound values, one int per circuit."""
        return [_ints(t[:, 0]) for t in self.t[:k]]


@dataclass
class LayerProofBatched:
    compressed_polys: List[List[int]]   # SumcheckInstanceProof rounds
    claims_prod_left: List[int]
    claims_prod_right: List[int]


@dataclass
class ProductCircuitEvalProofBatched:
    proof: List[LayerProofBatched]
    claims_dotp: Tuple[List[int], List[int], List[int]]

    @staticmethod
    def prove(prod: BatchedProductCircuits,
              dotp: Optional[BatchedDotProducts], transcript: Transcript):
        claims_dotp_final: Tuple[List[int], List[int], List[int]] = ([], [], [])
        proof_layers: List[LayerProofBatched] = []
        claims_to_verify = prod.evaluate()
        rand: List[int] = []

        for layer_id in reversed(range(len(prod.left_layers))):
            A = prod.left_layers[layer_id]
            B = prod.right_layers[layer_id]
            C = eq_evals(rand, A.device)
            if C.shape[0] != A.shape[1]:
                raise InternalError("product layer: eq table of the wrong size")
            C = C.expand(A.shape)
            num_rounds = A.shape[1].bit_length() - 1
            trip = _Tables(A, B, C)

            seq = None
            if layer_id == 0 and dotp is not None and dotp.k > 0:
                claims_to_verify = claims_to_verify + dotp.evaluate()
                seq = _Tables(dotp.left, dotp.right, dotp.weight)

            coeffs = transcript.challenge_vector(b"rand_coeffs_next_layer",
                                                 len(claims_to_verify))
            e = sum(c * v for c, v in zip(coeffs, claims_to_verify)) % L

            polys: List[List[int]] = []
            r_prod: List[int] = []
            for _ in range(num_rounds):
                evs = trip.round_evals()
                if seq is not None:
                    evs = [a + b for a, b in zip(evs, seq.round_evals())]
                ec0, ec2, ec3 = (sum(c * v for c, v in zip(coeffs, ev)) % L
                                 for ev in evs)
                poly = UniPoly.from_evals([ec0, (e - ec0) % L, ec2, ec3])
                poly.append_to_transcript(b"poly", transcript)
                r_j = transcript.challenge_scalar(b"challenge_nextround")
                r_prod.append(r_j)
                trip.bind(r_j)
                if seq is not None:
                    seq.bind(r_j)
                e = poly.evaluate(r_j)
                polys.append(poly.compress())

            claims_prod_left, claims_prod_right = trip.heads(2)
            for i in range(prod.K):
                transcript.append_scalar(b"claim_prod_left", claims_prod_left[i])
                transcript.append_scalar(b"claim_prod_right", claims_prod_right[i])

            if seq is not None:
                cl, cr, cw = seq.heads()
                for i in range(dotp.k):
                    transcript.append_scalar(b"claim_dotp_left", cl[i])
                    transcript.append_scalar(b"claim_dotp_right", cr[i])
                    transcript.append_scalar(b"claim_dotp_weight", cw[i])
                claims_dotp_final = (cl, cr, cw)

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                (claims_prod_left[i] + r_layer *
                 (claims_prod_right[i] - claims_prod_left[i])) % L
                for i in range(prod.K)]
            rand = [r_layer] + r_prod
            proof_layers.append(LayerProofBatched(
                polys, claims_prod_left, claims_prod_right))

        return (ProductCircuitEvalProofBatched(proof_layers, claims_dotp_final),
                rand)

    @verify_guard(failure=None)
    def verify(self, claims_prod_vec: List[int], claims_dotp_vec: List[int],
               length: int, transcript: Transcript):
        """-> (claims_to_verify, claims_to_verify_dotp, rand), or None."""
        num_layers = length.bit_length() - 1
        if len(self.proof) != num_layers:
            return None
        rand: List[int] = []
        claims_to_verify = list(claims_prod_vec)
        claims_to_verify_dotp: List[int] = []
        for i in range(num_layers):
            last = i == num_layers - 1
            if last:
                claims_to_verify = claims_to_verify + list(claims_dotp_vec)
            coeffs = transcript.challenge_vector(b"rand_coeffs_next_layer",
                                                 len(claims_to_verify))
            claim = sum(c * v for c, v in zip(coeffs, claims_to_verify)) % L

            res = SumcheckInstanceProof(self.proof[i].compressed_polys).verify(
                claim, i, 3, transcript)
            if res is None:
                return None
            claim_last, r_prod = res

            cpl = self.proof[i].claims_prod_left
            cpr = self.proof[i].claims_prod_right
            if len(cpl) != len(claims_prod_vec) or len(cpr) != len(cpl):
                return None
            for t in range(len(claims_prod_vec)):
                transcript.append_scalar(b"claim_prod_left", cpl[t])
                transcript.append_scalar(b"claim_prod_right", cpr[t])

            eq = 1
            for a, b in zip(rand, r_prod):
                eq = eq * (a * b + (1 - a) * (1 - b)) % L
            claim_expected = sum(coeffs[t] * cpl[t] % L * cpr[t] % L * eq
                                 for t in range(len(claims_prod_vec))) % L

            if last:
                npi = len(claims_prod_vec)
                cdl, cdr, cdw = self.claims_dotp
                if not len(cdl) == len(cdr) == len(cdw) == len(claims_dotp_vec):
                    return None
                for t in range(len(cdl)):
                    transcript.append_scalar(b"claim_dotp_left", cdl[t])
                    transcript.append_scalar(b"claim_dotp_right", cdr[t])
                    transcript.append_scalar(b"claim_dotp_weight", cdw[t])
                    claim_expected = (claim_expected + coeffs[t + npi] *
                                      cdl[t] % L * cdr[t] % L * cdw[t]) % L

            if claim_expected % L != claim_last % L:
                return None

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [(cpl[t] + r_layer * (cpr[t] - cpl[t])) % L
                                for t in range(len(cpl))]
            if last:
                for t in range(len(claims_dotp_vec) // 2):
                    for side in self.claims_dotp:
                        claims_to_verify_dotp.append(
                            (side[2 * t] + r_layer *
                             (side[2 * t + 1] - side[2 * t])) % L)
            rand = [r_layer] + r_prod
        return claims_to_verify, claims_to_verify_dotp, rand
