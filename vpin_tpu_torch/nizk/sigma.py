"""Sigma-protocol NIZKs over ristretto255 (Knowledge / Equality / Product /
DotProduct / DotProductLog) plus the Bulletproofs inner-product reduction.

Port of vpin_tpu/nizk/sigma.py: transcript labels and group equations
replicate the reference (Spartan/src/nizk/mod.rs:17-584,
nizk/bullet.rs:16-243).  Scalars are host ints mod l and small handfuls of
points are host arithmetic through RPoint; the bullet generator folds use
the device's cached digit table above BulletReductionProof.HOST_MAX
generators.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ..batch_verify import VerifyAccumulator, combine_compress, scale_terms
from ..commit.pedersen import MultiCommitGens, commit_scalar, commit_vec_ints
from ..curve import host_ristretto as hr
from ..curve.msm import host_digits
from ..curve.rpoint import RPoint, msm_host
from ..device import resolve_device
from ..field.prime_field import L_MODULUS as L
from ..transcript.merlin import Transcript
from ..utils.errors import verify_guard


def commit1(x: int, blind: int, gens: MultiCommitGens) -> RPoint:
    """x*G[0] + blind*h (gens.n == 1); host-int arithmetic."""
    return commit_scalar(x, blind, gens)


def commitN(xs: Sequence[int], blind: int, gens: MultiCommitGens,
            device=None) -> RPoint:
    """<xs, G> + blind*h (gens.n == len(xs))."""
    return commit_vec_ints(list(xs), blind, gens, device)


def append_scalars_vector(t: Transcript, label: bytes, v: Sequence[int]) -> None:
    """AppendToTranscript for [Scalar] (reference transcript.rs:57-66)."""
    t.append_message(label, b"begin_append_vector")
    for x in v:
        t.append_scalar(label, x)
    t.append_message(label, b"end_append_vector")


def dot_ints(a: Sequence[int], b: Sequence[int]) -> int:
    assert len(a) == len(b)
    return sum(x * y for x, y in zip(a, b)) % L


# ----------------------------------------------------------------------
# KnowledgeProof (nizk/mod.rs:17-76)
# ----------------------------------------------------------------------

@dataclass
class KnowledgeProof:
    alpha: bytes
    z1: int
    z2: int

    PROTOCOL = b"knowledge proof"

    @staticmethod
    def prove(gens_1, transcript, tape, x: int, r: int):
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL)
        t1 = tape.random_scalar(b"t1")
        t2 = tape.random_scalar(b"t2")
        C = commit1(x, r, gens_1).compress()
        transcript.append_point(b"C", C)
        alpha = commit1(t1, t2, gens_1).compress()
        transcript.append_point(b"alpha", alpha)
        c = transcript.challenge_scalar(b"c")
        z1 = (x * c + t1) % L
        z2 = (r * c + t2) % L
        return KnowledgeProof(alpha, z1, z2), C

    @verify_guard(failure=False)
    def verify(self, gens_1, transcript, C: bytes, acc=None) -> bool:
        local = acc is None
        if local:
            acc = VerifyAccumulator()
        transcript.append_protocol_name(KnowledgeProof.PROTOCOL)
        transcript.append_point(b"C", C)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        # z1*G + z2*h == c*C + alpha
        acc.add([(self.z1 % L, (gens_1, 0)), (self.z2 % L, (gens_1, -1)),
                 (L - c, bytes(C)), (L - 1, self.alpha)])
        return acc.check() if local else True


# ----------------------------------------------------------------------
# EqualityProof (nizk/mod.rs:80-146)
# ----------------------------------------------------------------------

@dataclass
class EqualityProof:
    alpha: bytes
    z: int

    PROTOCOL = b"equality proof"

    @staticmethod
    def prove(gens_1, transcript, tape, v1: int, s1: int, v2: int, s2: int):
        transcript.append_protocol_name(EqualityProof.PROTOCOL)
        r = tape.random_scalar(b"r")
        C1 = commit1(v1, s1, gens_1).compress()
        transcript.append_point(b"C1", C1)
        C2 = commit1(v2, s2, gens_1).compress()
        transcript.append_point(b"C2", C2)
        alpha = gens_1.h_point.mul(r).compress()
        transcript.append_point(b"alpha", alpha)
        c = transcript.challenge_scalar(b"c")
        z = (c * (s1 - s2) + r) % L
        return EqualityProof(alpha, z), C1, C2

    @verify_guard(failure=False)
    def verify(self, gens_1, transcript, C1: bytes, C2: bytes,
               acc=None) -> bool:
        local = acc is None
        if local:
            acc = VerifyAccumulator()
        transcript.append_protocol_name(EqualityProof.PROTOCOL)
        transcript.append_point(b"C1", C1)
        transcript.append_point(b"C2", C2)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        # z*h == c*(C1 - C2) + alpha
        acc.add([(self.z % L, (gens_1, -1)), (L - c, bytes(C1)),
                 (c % L, bytes(C2)), (L - 1, self.alpha)])
        return acc.check() if local else True


# ----------------------------------------------------------------------
# ProductProof (nizk/mod.rs:150-293)
# ----------------------------------------------------------------------

@dataclass
class ProductProof:
    alpha: bytes
    beta: bytes
    delta: bytes
    z: Tuple[int, int, int, int, int]

    PROTOCOL = b"product proof"

    @staticmethod
    def prove(gens_1, transcript, tape, x, rX, y, rY, zv, rZ):
        transcript.append_protocol_name(ProductProof.PROTOCOL)
        b1 = tape.random_scalar(b"b1")
        b2 = tape.random_scalar(b"b2")
        b3 = tape.random_scalar(b"b3")
        b4 = tape.random_scalar(b"b4")
        b5 = tape.random_scalar(b"b5")

        X = commit1(x, rX, gens_1).compress()
        transcript.append_point(b"X", X)
        Y = commit1(y, rY, gens_1).compress()
        transcript.append_point(b"Y", Y)
        Z = commit1(zv, rZ, gens_1).compress()
        transcript.append_point(b"Z", Z)
        alpha = commit1(b1, b2, gens_1).compress()
        transcript.append_point(b"alpha", alpha)
        beta = commit1(b3, b4, gens_1).compress()
        transcript.append_point(b"beta", beta)
        # delta = b3*X + b5*h
        Xp = RPoint.decompress(X)
        delta = (Xp.mul(b3) + gens_1.h_point.mul(b5)).compress()
        transcript.append_point(b"delta", delta)
        c = transcript.challenge_scalar(b"c")
        z1 = (b1 + c * x) % L
        z2 = (b2 + c * rX) % L
        z3 = (b3 + c * y) % L
        z4 = (b4 + c * rY) % L
        z5 = (b5 + c * (rZ - rX * y)) % L
        return ProductProof(alpha, beta, delta, (z1, z2, z3, z4, z5)), X, Y, Z

    @verify_guard(failure=False)
    def verify(self, gens_1, transcript, X: bytes, Y: bytes, Z: bytes,
               acc=None) -> bool:
        local = acc is None
        if local:
            acc = VerifyAccumulator()
        transcript.append_protocol_name(ProductProof.PROTOCOL)
        transcript.append_point(b"X", X)
        transcript.append_point(b"Y", Y)
        transcript.append_point(b"Z", Z)
        transcript.append_point(b"alpha", self.alpha)
        transcript.append_point(b"beta", self.beta)
        transcript.append_point(b"delta", self.delta)
        z1, z2, z3, z4, z5 = self.z
        c = transcript.challenge_scalar(b"c")
        # P + c*C == za*Gx + zb*h, for (alpha, X), (beta, Y), (delta, Z;X)
        acc.add([(1, self.alpha), (c % L, bytes(X)),
                 (L - z1 % L, (gens_1, 0)), (L - z2 % L, (gens_1, -1))])
        acc.add([(1, self.beta), (c % L, bytes(Y)),
                 (L - z3 % L, (gens_1, 0)), (L - z4 % L, (gens_1, -1))])
        acc.add([(1, self.delta), (c % L, bytes(Z)),
                 (L - z3 % L, bytes(X)), (L - z5 % L, (gens_1, -1))])
        return acc.check() if local else True


# ----------------------------------------------------------------------
# DotProductProof — linear size (nizk/mod.rs:297-409)
# ----------------------------------------------------------------------

@dataclass
class DotProductProof:
    delta: bytes
    beta: bytes
    z: List[int]
    z_delta: int
    z_beta: int

    PROTOCOL = b"dot product proof"

    @staticmethod
    def prove(gens_1, gens_n, transcript, tape,
              x_vec: Sequence[int], blind_x: int,
              a_vec: Sequence[int], y: int, blind_y: int):
        transcript.append_protocol_name(DotProductProof.PROTOCOL)
        n = len(x_vec)
        assert len(a_vec) == n and gens_n.n == n and gens_1.n == 1

        d_vec = tape.random_vector(b"d_vec", n)
        r_delta = tape.random_scalar(b"r_delta")
        r_beta = tape.random_scalar(b"r_beta")

        Cx = commitN(x_vec, blind_x, gens_n).compress()
        transcript.append_point(b"Cx", Cx)
        Cy = commit1(y, blind_y, gens_1).compress()
        transcript.append_point(b"Cy", Cy)
        append_scalars_vector(transcript, b"a", a_vec)

        delta = commitN(d_vec, r_delta, gens_n).compress()
        transcript.append_point(b"delta", delta)
        beta = commit1(dot_ints(a_vec, d_vec), r_beta, gens_1).compress()
        transcript.append_point(b"beta", beta)

        c = transcript.challenge_scalar(b"c")
        z = [(c * x_vec[i] + d_vec[i]) % L for i in range(n)]
        z_delta = (c * blind_x + r_delta) % L
        z_beta = (c * blind_y + r_beta) % L
        return DotProductProof(delta, beta, z, z_delta, z_beta), Cx, Cy

    @verify_guard(failure=False)
    def verify(self, gens_1, gens_n, transcript, a: Sequence[int],
               Cx: bytes, Cy: bytes, acc=None) -> bool:
        assert gens_n.n == len(a) and gens_1.n == 1
        local = acc is None
        if local:
            acc = VerifyAccumulator()
        transcript.append_protocol_name(DotProductProof.PROTOCOL)
        transcript.append_point(b"Cx", Cx)
        transcript.append_point(b"Cy", Cy)
        append_scalars_vector(transcript, b"a", a)
        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)
        c = transcript.challenge_scalar(b"c")

        # c*Cx + delta == <z, G> + z_delta*h
        eq1 = [(c % L, bytes(Cx)), (1, self.delta)]
        eq1 += [((L - z) % L, (gens_n, i)) for i, z in enumerate(self.z)]
        eq1.append(((L - self.z_delta) % L, (gens_n, -1)))
        acc.add(eq1)
        # c*Cy + beta == <z, a>*G1 + z_beta*h
        acc.add([(c % L, bytes(Cy)), (1, self.beta),
                 ((L - dot_ints(self.z, a)) % L, (gens_1, 0)),
                 ((L - self.z_beta) % L, (gens_1, -1))])
        return acc.check() if local else True


# ----------------------------------------------------------------------
# BulletReductionProof (nizk/bullet.rs)
# ----------------------------------------------------------------------

@dataclass
class BulletReductionProof:
    L_vec: List[bytes]
    R_vec: List[bytes]

    #: above this many generators the round folds run on the device
    HOST_MAX = 256

    @staticmethod
    def prove(transcript, Q: RPoint, gens_n, H: RPoint,
              a_vec: Sequence[int], b_vec: Sequence[int], blind: int,
              blinds_vec: Sequence[Tuple[int, int]], device=None):
        """gens_n: MultiCommitGens holding the n generators.  Small n runs
        entirely on host ints; large n takes gens_n's cached digit table on
        ``device`` (_prove_dev).  Matches bullet.rs:32-132 on the
        transcript."""
        a = [x % L for x in a_vec]
        b = [x % L for x in b_vec]
        n = gens_n.n
        assert n & (n - 1) == 0
        lg_n = n.bit_length() - 1
        assert len(blinds_vec) == 2 * lg_n

        if n <= BulletReductionProof.HOST_MAX:
            return BulletReductionProof._prove_host(
                transcript, Q, gens_n.Gh, H, a, b, blind, blinds_vec)
        return BulletReductionProof._prove_dev(
            transcript, Q, gens_n, H, a, b, blind, blinds_vec,
            resolve_device(device))

    @staticmethod
    def _prove_host(transcript, Q, G_list, H_pt, a, b, blind, blinds_vec):
        n = len(G_list)
        L_out, R_out = [], []
        blind_fin = blind % L
        bi = iter(blinds_vec)
        G = list(G_list)

        while n != 1:
            n //= 2
            a_Lh, a_R = a[:n], a[n:]
            b_Lh, b_R = b[:n], b[n:]
            G_L, G_R = G[:n], G[n:]

            c_L = dot_ints(a_Lh, b_R)
            c_R = dot_ints(a_R, b_Lh)
            blind_L, blind_R = next(bi)

            Lc = hr.msm(a_Lh + [c_L, blind_L], G_R + [Q.h, H_pt.h]).encode()
            Rc = hr.msm(a_R + [c_R, blind_R], G_L + [Q.h, H_pt.h]).encode()
            transcript.append_point(b"L", Lc)
            transcript.append_point(b"R", Rc)
            u = transcript.challenge_scalar(b"u")
            u_inv = pow(u, -1, L)

            a = [(a_Lh[i] * u + u_inv * a_R[i]) % L for i in range(n)]
            b = [(b_Lh[i] * u_inv + u * b_R[i]) % L for i in range(n)]
            G = [hr.msm([u_inv, u], [G_L[i], G_R[i]]) for i in range(n)]

            blind_fin = (blind_fin + blind_L * u * u + blind_R * u_inv * u_inv) % L
            L_out.append(Lc)
            R_out.append(Rc)

        g_fin = RPoint(G[0])
        Gamma_hat = msm_host([a[0], a[0] * b[0] % L, blind_fin],
                             [g_fin, Q, H_pt])
        return (BulletReductionProof(L_out, R_out), Gamma_hat,
                a[0], b[0], g_fin, blind_fin)

    @staticmethod
    def _prove_dev(transcript, Q, gens_n, H_pt, a, b, blind, blinds_vec,
                   device):
        """Foldless bullet rounds: after j rounds, folded generator k is a
        known challenge-product combination of the ORIGINAL generators
        (exactly the verifier's s-vector structure, bullet.rs:137-185), so
        the prover never materializes folded vectors.  Per round it
        combines scalars on the host (2n modmuls) and issues ONE gather
        MSM per cross term against gens_n's CACHED digit table — replacing
        two fresh table builds plus two 253-bit generator-fold ladders
        (~1000 batched group ops) per round."""
        n0 = gens_n.n
        msm_t = gens_n.G_msm(device)
        L_out, R_out = [], []
        blind_fin = blind % L
        bi = iter(blinds_vec)
        coef = [1] * n0                 # original-gen coefficients
        cur = n0

        def table_msm(scalars):
            return RPoint.from_dev(msm_t.msm(torch.as_tensor(
                host_digits(scalars), device=device)))

        while cur != 1:
            m = cur // 2
            a_Lh, a_R = a[:m], a[m:]
            b_Lh, b_R = b[:m], b[m:]
            c_L = dot_ints(a_Lh, b_R)
            c_R = dot_ints(a_R, b_Lh)
            blind_L, blind_R = next(bi)

            sL = [0] * n0
            sR = [0] * n0
            for i in range(n0):
                p = i % cur
                if p >= m:
                    sL[i] = coef[i] * a_Lh[p - m] % L
                else:
                    sR[i] = coef[i] * a_R[p] % L
            Lp = table_msm(sL) + Q.mul(c_L) + H_pt.mul(blind_L)
            Rp = table_msm(sR) + Q.mul(c_R) + H_pt.mul(blind_R)
            Lc, Rc = Lp.compress(), Rp.compress()
            transcript.append_point(b"L", Lc)
            transcript.append_point(b"R", Rc)
            u = transcript.challenge_scalar(b"u")
            u_inv = pow(u, -1, L)

            a = [(a_Lh[i] * u + u_inv * a_R[i]) % L for i in range(m)]
            b = [(b_Lh[i] * u_inv + u * b_R[i]) % L for i in range(m)]
            for i in range(n0):
                coef[i] = coef[i] * (u_inv if (i % cur) < m else u) % L

            blind_fin = (blind_fin + blind_L * u * u + blind_R * u_inv * u_inv) % L
            L_out.append(Lc)
            R_out.append(Rc)
            cur = m

        g_fin = table_msm(coef)
        Gamma_hat = msm_host([a[0], a[0] * b[0] % L, blind_fin],
                             [g_fin, Q, H_pt])
        return (BulletReductionProof(L_out, R_out), Gamma_hat,
                a[0], b[0], g_fin, blind_fin)

    def verification_scalars(self, n: int, transcript):
        lg_n = len(self.L_vec)
        assert n == (1 << lg_n)
        challenges = []
        for Lc, Rc in zip(self.L_vec, self.R_vec):
            transcript.append_point(b"L", Lc)
            transcript.append_point(b"R", Rc)
            challenges.append(transcript.challenge_scalar(b"u"))
        challenges_inv = [pow(u, -1, L) for u in challenges]
        allinv = 1
        for ui in challenges_inv:
            allinv = allinv * ui % L
        u_sq = [u * u % L for u in challenges]
        u_inv_sq = [u * u % L for u in challenges_inv]
        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s.append(s[i - k] * u_sq[(lg_n - 1) - lg_i] % L)
        return u_sq, u_inv_sq, s

    @verify_guard(failure=None)
    def verify_terms(self, n: int, a: Sequence[int], transcript,
                     Gamma_terms):
        """Deferred form: returns (G_hat_terms, Gamma_hat_terms, a_hat)
        — the verifier's one-big-MSM trick (bullet.rs:191-225) expressed
        as linear term lists for the batch accumulator."""
        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript)
        G_hat_terms = [(s_i % L, i) for i, s_i in enumerate(s)]  # gens idx
        a_hat = dot_ints(a, s)
        Gamma_hat_terms = (
            [(u % L, bytes(Lc)) for u, Lc in zip(u_sq, self.L_vec)]
            + [(u % L, bytes(Rc)) for u, Rc in zip(u_inv_sq, self.R_vec)]
            + list(Gamma_terms))
        return G_hat_terms, Gamma_hat_terms, a_hat


# ----------------------------------------------------------------------
# DotProductProofLog (nizk/mod.rs:429-584)
# ----------------------------------------------------------------------

@dataclass
class DotProductProofLog:
    bullet: BulletReductionProof
    delta: bytes
    beta: bytes
    z1: int
    z2: int

    PROTOCOL = b"dot product proof (log)"

    @staticmethod
    def prove(gens, transcript, tape,
              x_vec: Sequence[int], blind_x: int,
              a_vec: Sequence[int], y: int, blind_y: int, device=None):
        """gens: DotProductProofGens (has .n, .gens_n, .gens_1); ``device``
        takes the bullet folds above BulletReductionProof.HOST_MAX."""
        transcript.append_protocol_name(DotProductProofLog.PROTOCOL)
        n = len(x_vec)
        assert len(a_vec) == n and gens.n == n
        lg_n = n.bit_length() - 1

        d = tape.random_scalar(b"d")
        r_delta = tape.random_scalar(b"r_delta")
        r_beta = tape.random_scalar(b"r_delta")
        v1 = tape.random_vector(b"blinds_vec_1", 2 * lg_n)
        v2 = tape.random_vector(b"blinds_vec_2", 2 * lg_n)
        blinds_vec = list(zip(v1, v2))

        Cx = commitN(x_vec, blind_x, gens.gens_n, device).compress()
        transcript.append_point(b"Cx", Cx)
        Cy = commit1(y, blind_y, gens.gens_1).compress()
        transcript.append_point(b"Cy", Cy)
        append_scalars_vector(transcript, b"a", a_vec)

        r = transcript.challenge_scalar(b"r")
        gens_1_scaled_G = gens.gens_1.G_point(0).mul(r)
        h = gens.gens_1.h_point

        blind_Gamma = (blind_x + r * blind_y) % L
        bullet, Gamma_hat, x_hat, a_hat, g_hat, rhat_Gamma = \
            BulletReductionProof.prove(transcript, gens_1_scaled_G,
                                       gens.gens_n, h,
                                       x_vec, a_vec, blind_Gamma, blinds_vec,
                                       device=device)
        y_hat = x_hat * a_hat % L

        delta = (g_hat.mul(d) + h.mul(r_delta)).compress()
        transcript.append_point(b"delta", delta)
        beta = (gens_1_scaled_G.mul(d) + h.mul(r_beta)).compress()
        transcript.append_point(b"beta", beta)

        c = transcript.challenge_scalar(b"c")
        z1 = (d + c * y_hat) % L
        z2 = (a_hat * (c * rhat_Gamma + r_beta) + r_delta) % L
        return DotProductProofLog(bullet, delta, beta, z1, z2), Cx, Cy

    @verify_guard(failure=False)
    def verify(self, n: int, gens, transcript, a: Sequence[int],
               Cx: bytes, Cy, acc=None) -> bool:
        """Cx: compressed bytes (appended to the transcript); Cy: bytes
        OR a term list for verifier-combined claims."""
        assert gens.n == n and len(a) == n
        local = acc is None
        if local:
            acc = VerifyAccumulator()
        transcript.append_protocol_name(DotProductProofLog.PROTOCOL)
        transcript.append_point(b"Cx", Cx)
        if isinstance(Cy, (bytes, bytearray)):
            Cy_b = bytes(Cy)
        else:
            Cy_b = combine_compress(*_terms_to_points_scalars(Cy))
        transcript.append_point(b"Cy", Cy_b)
        append_scalars_vector(transcript, b"a", a)

        r = transcript.challenge_scalar(b"r")
        Gamma_terms = [(1, bytes(Cx)), (r % L, Cy_b)]

        res = self.bullet.verify_terms(n, a, transcript, Gamma_terms)
        if res is None:
            return None if not local else False
        g_hat_terms, Gamma_hat_terms, a_hat = res
        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)
        c = transcript.challenge_scalar(b"c")

        # (c*Gamma_hat + beta)*a_hat + delta == z1*g_hat + ..., flattened
        # to lhs - rhs == 0 with
        # lhs = (c*a_hat)*Gamma_hat + a_hat*beta + delta
        # rhs = z1*g_hat + (r*a_hat*z1)*G1 + z2*h
        eq = scale_terms(Gamma_hat_terms, c * a_hat % L)
        eq += [(a_hat % L, self.beta), (1, self.delta)]
        eq += [((L - si * self.z1) % L, (gens.gens_n, i))
               for si, i in g_hat_terms]
        eq += [((L - r * a_hat * self.z1) % L, (gens.gens_1, 0)),
               ((L - self.z2) % L, (gens.gens_1, -1))]
        acc.add(eq)
        return acc.check() if local else True


def _terms_to_points_scalars(terms):
    """Materialization helper: term list (scalars x bytes/RPoint/gens-idx)
    -> (points, scalars) for combine_compress."""
    pts, ss = [], []
    for s, ref in terms:
        if isinstance(ref, (bytes, bytearray)):
            pts.append(RPoint.decompress(bytes(ref)))
        elif isinstance(ref, RPoint):
            pts.append(ref)
        else:
            gens, idx = ref
            if idx == -1:
                pts.append(gens.h_point)
            else:
                pts.append(gens.G_point(idx))
        ss.append(s % L)
    return pts, ss


class DotProductProofGens:
    """reference: nizk/mod.rs DotProductProofGens::new."""

    def __init__(self, n: int, label: bytes):
        self.n = n
        full = MultiCommitGens.new(n + 1, label)
        self.gens_n, self.gens_1 = full.split_at(n)


@functools.lru_cache(maxsize=None)
def dot_product_proof_gens(n: int, label: bytes) -> DotProductProofGens:
    """Cached per (n, label) so the split gens — and their MSM digit
    tables — persist across proofs in one process."""
    return DotProductProofGens(n, label)
