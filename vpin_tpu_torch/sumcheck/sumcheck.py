"""Zero-knowledge sumcheck prover and verifier (the two R1CS sumchecks).

Port of vpin_tpu/sumcheck/sumcheck.py (reference Spartan/src/sumcheck.rs and
unipoly.rs), bit for bit on the transcript.  Each round's evaluation sums
and the binding of the tables run as batched tensor expressions of K1
products over the halved tables; the per-round protocol (UniPoly
interpolation, Pedersen commitments, DotProductProof) is exact host
arithmetic.  The non-ZK sumcheck (SPARK's product circuits) shares the
round sums.  Under an active mesh the sumchecks' round sums and binds split
over it (parallel/ops.py); SPARK's product trees, which call round_sums and
bind_tables directly, do not, as in vpin_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..batch_verify import VerifyAccumulator, combine_compress
from ..curve.rpoint import RPoint, decompress_many
from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..nizk.sigma import DotProductProof, commit1, commitN
from ..parallel.mesh import get_mesh
from ..parallel.ops import sharded_round_evals
from ..poly.dense import DensePoly, bound_top
from ..transcript.merlin import Transcript
from ..utils.checkpoint import ROUNDS_PER_CHECKPOINT
from ..utils.errors import verify_guard

_INV2 = pow(2, -1, L)
_INV6 = pow(6, -1, L)


# ----------------------------------------------------------------------
# UniPoly (reference: Spartan/src/unipoly.rs)
# ----------------------------------------------------------------------

class UniPoly:
    """Degree-2/3 univariate poly; coeffs low-to-high, host ints."""

    def __init__(self, coeffs: List[int]):
        self.coeffs = [c % L for c in coeffs]

    @staticmethod
    def from_evals(evals: Sequence[int]) -> "UniPoly":
        e = [x % L for x in evals]
        if len(e) == 3:
            c = e[0]
            a = _INV2 * (e[2] - e[1] - e[1] + c) % L
            b = (e[1] - c - a) % L
            return UniPoly([c, b, a])
        if len(e) != 4:
            raise ValueError("UniPoly.from_evals takes 3 or 4 evaluations")
        d = e[0]
        a = _INV6 * (e[3] - 3 * e[2] + 3 * e[1] - e[0]) % L
        b = _INV2 * (2 * e[0] - 5 * e[1] + 4 * e[2] - e[3]) % L
        c = (e[1] - d - a - b) % L
        return UniPoly([d, c, b, a])

    @property
    def degree(self) -> int:
        return len(self.coeffs) - 1

    def eval_at_zero(self) -> int:
        return self.coeffs[0]

    def eval_at_one(self) -> int:
        return sum(self.coeffs) % L

    def evaluate(self, r: int) -> int:
        acc, power = self.coeffs[0], r
        for c in self.coeffs[1:]:
            acc = (acc + power * c) % L
            power = power * r % L
        return acc

    def compress(self) -> List[int]:
        """coeffs except the linear term (reference proof-size trick)."""
        return [self.coeffs[0]] + self.coeffs[2:]

    @staticmethod
    def decompress(compressed: Sequence[int], hint: int) -> "UniPoly":
        linear = (hint - 2 * compressed[0] - sum(compressed[1:])) % L
        return UniPoly([compressed[0], linear] + list(compressed[1:]))

    def append_to_transcript(self, label: bytes, t: Transcript) -> None:
        t.append_message(label, b"UniPoly_begin")
        for c in self.coeffs:
            t.append_scalar(b"coeff", c)
        t.append_message(label, b"UniPoly_end")

    def commit(self, gens, blind: int) -> RPoint:
        return commitN(self.coeffs, blind, gens)


# ----------------------------------------------------------------------
# round evaluations and binds
# ----------------------------------------------------------------------

def round_sums(kind: str, tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """Round evaluation sums over tables (..., 2n, 8), halved and summed
    along their second-to-last axis, as Montgomery limbs (points, ..., 8):
      quad            sum A*B at t = 0, 2
      cubic           sum A*B*C at t = 0, 2, 3
      cubic_additive  sum A*(B*C - D) at t = 0, 2, 3
    where a table at t is lo + t (hi - lo).  The points t are stacked on a
    leading axis, so each product is one K1 launch over all of them."""
    n = tables[0].shape[-2] // 2
    return round_sums_split(kind, [t[..., :n, :] for t in tables],
                            [t[..., n:, :] for t in tables])


def round_sums_split(kind: str, los: Sequence[torch.Tensor],
                     his: Sequence[torch.Tensor]) -> torch.Tensor:
    """``round_sums`` over tables given as their lo and hi halves."""
    F = FQ
    at2 = [F.sub(F.add(h, h), lo) for lo, h in zip(los, his)]
    if kind == "quad":
        pts = [torch.stack([lo, v2]) for lo, v2 in zip(los, at2)]
        terms = F.mul(pts[0], pts[1])
    elif kind in ("cubic", "cubic_additive"):
        at3 = [F.add(v2, F.sub(h, lo)) for v2, lo, h in zip(at2, los, his)]
        pts = [torch.stack(v) for v in zip(los, at2, at3)]
        if kind == "cubic":
            terms = F.mul(F.mul(pts[0], pts[1]), pts[2])
        else:
            a, b, c, d = pts
            terms = F.mul(a, F.sub(F.mul(b, c), d))
    else:
        raise ValueError(f"unknown round kind {kind!r}")
    return F.sum_reduce(terms, axis=terms.dim() - 2)


def round_evals(kind: str, tables: Sequence[torch.Tensor]) -> List[int]:
    """``round_sums`` of (2n, 8) tables as host ints, the half axis split
    over the active mesh when one is set (parallel/ops.py)."""
    sums = sharded_round_evals(kind, tables)
    if sums is None:
        sums = round_sums(kind, tables)
    return [int(v) for v in FQ.from_mont(sums)]


def round_evals_host(kind: str, tabs: Sequence[List[int]]) -> List[int]:
    """The same sums over host int tables (exact arithmetic mod l)."""
    n = len(tabs[0]) // 2
    los = [t[:n] for t in tabs]
    his = [t[n:] for t in tabs]
    if kind == "quad":
        Al, Bl = los
        Ah, Bh = his
        e0 = sum(a * b % L for a, b in zip(Al, Bl)) % L
        e2 = sum((2 * ah - al) * (2 * bh - bl) % L
                 for al, ah, bl, bh in zip(Al, Ah, Bl, Bh)) % L
        return [e0, e2]
    if kind == "cubic":
        comb = lambda v: v[0] * v[1] % L * v[2]              # noqa: E731
    elif kind == "cubic_additive":
        comb = lambda v: v[0] * (v[1] * v[2] - v[3]) % L     # noqa: E731
    else:
        raise ValueError(f"unknown round kind {kind!r}")
    k = len(tabs)
    e0 = e2 = e3 = 0
    for i in range(n):
        v0 = [los[j][i] for j in range(k)]
        e0 += comb(v0)
        v2 = [2 * his[j][i] - los[j][i] for j in range(k)]
        e2 += comb(v2)
        v3 = [v2[j] + his[j][i] - los[j][i] for j in range(k)]
        e3 += comb(v3)
    return [e0 % L, e2 % L, e3 % L]


def bind_tables(tables: Sequence[torch.Tensor], r: int) -> List[torch.Tensor]:
    """Bind the top variable of tables (..., 2n, 8) of one shape to r along
    their second-to-last axis: lo + r (hi - lo), all in one K1 launch."""
    F = FQ
    n = tables[0].shape[-2] // 2
    T = torch.stack(list(tables))
    lo, hi = T[..., :n, :], T[..., n:, :]
    r_dev = F.to_mont([r], T.device)[0]
    return list(F.add(lo, F.mul(r_dev, F.sub(hi, lo))).unbind(0))


def bind_polys(tables: Sequence[torch.Tensor], r: int) -> List[torch.Tensor]:
    """The sumchecks' binds of (2n, 8) tables: ``bind_tables`` in one
    launch, or under an active mesh each table's ``bound_top``, whose half
    axis splits over it (as vpin_tpu binds each DensePoly there)."""
    if get_mesh() is None:
        return bind_tables(tables, r)
    return [bound_top(t, r) for t in tables]


# ----------------------------------------------------------------------
# non-ZK sumcheck (SumcheckInstanceProof)
# ----------------------------------------------------------------------

@dataclass
class SumcheckInstanceProof:
    """The plain sumcheck (reference sumcheck.rs SumcheckInstanceProof):
    each round's compressed UniPoly in the clear."""
    compressed_polys: List[List[int]]

    @verify_guard(failure=None)
    def verify(self, claim: int, num_rounds: int, degree_bound: int,
               transcript: Transcript) -> Tuple[int, List[int]]:
        """-> (final claim, challenges), or None when a round fails."""
        e = claim % L
        r: List[int] = []
        if len(self.compressed_polys) != num_rounds:
            return None
        for comp in self.compressed_polys:
            poly = UniPoly.decompress(comp, e)
            if poly.degree != degree_bound or \
                    (poly.eval_at_zero() + poly.eval_at_one()) % L != e:
                return None
            poly.append_to_transcript(b"poly", transcript)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r

    @staticmethod
    def prove_cubic(claim: int, num_rounds: int, poly_A: DensePoly,
                    poly_B: DensePoly, poly_C: DensePoly,
                    transcript: Transcript):
        """Sumcheck of sum A*B*C; -> (proof, challenges, [A, B, C] at them).
        The DensePolys are bound in place, all host or all tensor."""
        e = claim % L
        r: List[int] = []
        polys: List[List[int]] = []
        ps = (poly_A, poly_B, poly_C)
        for _ in range(num_rounds):
            if poly_A.is_host:
                e0, e2, e3 = round_evals_host("cubic", [p.Zh for p in ps])
            else:
                e0, e2, e3 = round_evals("cubic", [p.Z for p in ps])
            poly = UniPoly.from_evals([e0, (e - e0) % L, e2, e3])
            poly.append_to_transcript(b"poly", transcript)
            r_j = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_j)
            if poly_A.is_host:
                for p in ps:
                    p.bound_poly_var_top(r_j)
            else:
                for p, t in zip(ps, bind_polys([p.Z for p in ps], r_j)):
                    p.Z = t
            e = poly.evaluate(r_j)
            polys.append(poly.compress())
        return (SumcheckInstanceProof(polys), r,
                [p.index(0) for p in ps])


# ----------------------------------------------------------------------
# ZK sumcheck (ZKSumcheckInstanceProof)
# ----------------------------------------------------------------------

@dataclass
class ZKSumcheckInstanceProof:
    comm_polys: List[bytes]
    comm_evals: List[bytes]
    proofs: List[DotProductProof]

    @verify_guard(failure=None)
    def verify(self, comm_claim: bytes, num_rounds: int, degree_bound: int,
               gens_1, gens_n, transcript: Transcript, acc=None):
        """Deferred batch verification: each round materializes only the
        combined-claim commitment the transcript needs and defers its group
        equations into ``acc``."""
        local = acc is None
        if local:
            acc = VerifyAccumulator()
        if gens_n.n != degree_bound + 1 or not (
                len(self.comm_polys) == len(self.comm_evals)
                == len(self.proofs) == num_rounds):
            return None

        chain = [bytes(comm_claim)] + [bytes(b) for b in self.comm_evals]
        chain_pts = decompress_many(chain)

        r: List[int] = []
        for i in range(num_rounds):
            comm_poly = self.comm_polys[i]
            transcript.append_point(b"comm_poly", comm_poly)
            r_i = transcript.challenge_scalar(b"challenge_nextround")

            transcript.append_point(b"comm_claim_per_round", chain[i])
            transcript.append_point(b"comm_eval", self.comm_evals[i])
            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)

            comm_target = combine_compress(
                [chain_pts[i], chain_pts[i + 1]], w)

            a_sc = [1] * (degree_bound + 1)
            a_sc[0] = 2
            a_eval = [1]
            for _ in range(degree_bound):
                a_eval.append(a_eval[-1] * r_i % L)
            a = [(w[0] * a_sc[j] + w[1] * a_eval[j]) % L
                 for j in range(degree_bound + 1)]

            if not self.proofs[i].verify(gens_1, gens_n, transcript, a,
                                         comm_poly, comm_target, acc=acc):
                return None
            r.append(r_i)
        if local and not acc.check():
            return None
        return self.comm_evals[-1], r

    @staticmethod
    def _prove_rounds(claim, blind_claim, num_rounds, polys, kind,
                      gens_1, gens_n, transcript, tape,
                      ckpt=None, ckpt_key=""):
        """Shared round loop; kind in {'quad', 'cubic_additive'}.  polys
        are DensePolys, all host or all tensor.

        With a CheckpointStore ``ckpt``, every ROUNDS_PER_CHECKPOINT rounds
        (and after the last) the sponges and the artifacts so far are saved
        under ``ckpt_key``, as host ints and bytes only.  On resume the
        bound tables are rebuilt by binding the fresh tables to the
        recorded challenges again; no table is ever stored."""
        blinds_poly = tape.random_vector(b"blinds_poly", num_rounds)
        blinds_evals = tape.random_vector(b"blinds_evals", num_rounds)

        claim_per_round = claim % L
        comm_claim_per_round = commit1(claim_per_round, blind_claim,
                                       gens_1).compress()

        r: List[int] = []
        comm_polys: List[bytes] = []
        comm_evals: List[bytes] = []
        proofs: List[DotProductProof] = []

        host = polys[0].is_host
        tabs = [p.Zh if host else p.Z for p in polys]

        def bind(tabs, r_j):
            if host:
                for p in polys:
                    p.bound_poly_var_top(r_j)
                return [p.Zh for p in polys]
            return bind_polys(tabs, r_j)

        start = 0
        snap = ckpt.load(ckpt_key) if ckpt is not None else None
        if snap is not None and snap["num_rounds"] == num_rounds:
            transcript.restore(snap["transcript"])
            tape.restore(snap["tape"])
            r = list(snap["r"])
            comm_polys = list(snap["comm_polys"])
            comm_evals = list(snap["comm_evals"])
            proofs = list(snap["proofs"])
            claim_per_round = snap["claim_per_round"]
            comm_claim_per_round = snap["comm_claim_per_round"]
            start = snap["j"]
            for r_j in r:                  # replay the binds up to round start
                tabs = bind(tabs, r_j)

        for j in range(start, num_rounds):
            ev = (round_evals_host(kind, tabs) if host
                  else round_evals(kind, tabs))
            if kind == "quad":
                e0, e2 = ev
                evals = [e0, (claim_per_round - e0) % L, e2]
            else:
                e0, e2, e3 = ev
                evals = [e0, (claim_per_round - e0) % L, e2, e3]
            poly = UniPoly.from_evals(evals)
            comm_poly = poly.commit(gens_n, blinds_poly[j]).compress()
            transcript.append_point(b"comm_poly", comm_poly)
            comm_polys.append(comm_poly)

            r_j = transcript.challenge_scalar(b"challenge_nextround")
            tabs = bind(tabs, r_j)

            eval_r = poly.evaluate(r_j)
            comm_eval = commit1(eval_r, blinds_evals[j], gens_1).compress()
            transcript.append_point(b"comm_claim_per_round", comm_claim_per_round)
            transcript.append_point(b"comm_eval", comm_eval)
            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)

            target = (w[0] * claim_per_round + w[1] * eval_r) % L
            blind_sc = blind_claim if j == 0 else blinds_evals[j - 1]
            blind = (w[0] * blind_sc + w[1] * blinds_evals[j]) % L

            a_sc = [1] * (poly.degree + 1)
            a_sc[0] = 2
            a_eval = [1]
            for _ in range(poly.degree):
                a_eval.append(a_eval[-1] * r_j % L)
            a = [(w[0] * a_sc[t] + w[1] * a_eval[t]) % L
                 for t in range(poly.degree + 1)]

            proof, _, _ = DotProductProof.prove(
                gens_1, gens_n, transcript, tape,
                poly.coeffs, blinds_poly[j], a, target, blind)

            proofs.append(proof)
            claim_per_round = eval_r
            comm_claim_per_round = comm_eval
            r.append(r_j)
            comm_evals.append(comm_eval)

            if ckpt is not None and ((j + 1) % ROUNDS_PER_CHECKPOINT == 0
                                     or j + 1 == num_rounds):
                ckpt.save(ckpt_key, {
                    "num_rounds": num_rounds, "j": j + 1,
                    "transcript": transcript.snapshot(),
                    "tape": tape.snapshot(),
                    "r": list(r), "comm_polys": list(comm_polys),
                    "comm_evals": list(comm_evals), "proofs": list(proofs),
                    "claim_per_round": claim_per_round,
                    "comm_claim_per_round": comm_claim_per_round,
                })

        if host:
            claims = [t[0] for t in tabs]
        else:
            claims = [int(v) for v in
                      FQ.from_mont(torch.stack([t[0] for t in tabs]))]
        return (ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs),
                r, claims, blinds_evals[num_rounds - 1])

    @staticmethod
    def prove_quad(claim, blind_claim, num_rounds, poly_A, poly_B,
                   gens_1, gens_n, transcript, tape, ckpt=None, ckpt_key=""):
        return ZKSumcheckInstanceProof._prove_rounds(
            claim, blind_claim, num_rounds, [poly_A, poly_B], "quad",
            gens_1, gens_n, transcript, tape, ckpt=ckpt, ckpt_key=ckpt_key)

    @staticmethod
    def prove_cubic_with_additive_term(claim, blind_claim, num_rounds,
                                       poly_A, poly_B, poly_C, poly_D,
                                       gens_1, gens_n, transcript, tape,
                                       ckpt=None, ckpt_key=""):
        return ZKSumcheckInstanceProof._prove_rounds(
            claim, blind_claim, num_rounds, [poly_A, poly_B, poly_C, poly_D],
            "cubic_additive", gens_1, gens_n, transcript, tape,
            ckpt=ckpt, ckpt_key=ckpt_key)
