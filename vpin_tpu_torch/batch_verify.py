"""Deferred batched proof verification, on the host.

Port of vpin_tpu/batch_verify.py.  Transcript replay drives the challenge
stream exactly as the reference does, while every group equation
sum_i s_i * P_i == identity is deferred into a VerifyAccumulator.  At the
end all equations are combined with verifier-private random weights rho_j
(if any single equation fails, the combination fails except with
probability ~2^-253) and checked with one host MSM.  The port's verifier is
host-only by construction: it never reaches a device, whatever the size.

Equation terms reference points three ways:
  (s, bytes)            -- a compressed proof point (decoded once)
  (s, (gens, i))        -- generator i of a MultiCommitGens (i = -1: h)
  (s, RPoint)           -- an already-decoded point
"""

from __future__ import annotations

import secrets
from typing import List, Sequence, Tuple

from .curve import host_ristretto as H
from .curve.rpoint import RPoint
from .field.prime_field import L_MODULUS as L

Term = Tuple[int, object]


def as_terms(x) -> List[Term]:
    """bytes | RPoint | term list -> term list."""
    if isinstance(x, (bytes, bytearray)):
        return [(1, bytes(x))]
    if isinstance(x, RPoint):
        return [(1, x)]
    return list(x)


def scale_terms(terms: Sequence[Term], k: int) -> List[Term]:
    k = k % L
    return [(s * k % L, ref) for s, ref in terms]


def neg_terms(terms: Sequence[Term]) -> List[Term]:
    return [((L - s) % L, ref) for s, ref in terms]


def combine_compress(points: Sequence[RPoint], scalars: Sequence[int]) -> bytes:
    """sum_i s_i * P_i as compressed bytes (verifier-computed points that
    enter the transcript; always a handful of points)."""
    return H.msm([s % L for s in scalars], [p.h for p in points]).encode()


class VerifyAccumulator:
    """Collects group equations; check() verifies them all at once."""

    def __init__(self):
        self.eqs: List[List[Term]] = []

    def add(self, *groups) -> None:
        """One equation: the concatenated term groups sum to the identity."""
        eq: List[Term] = []
        for g in groups:
            eq.extend(as_terms(g))
        self.eqs.append(eq)

    def check(self) -> bool:
        if not self.eqs:
            return True
        byte_coeff = {}
        gens_coeff = {}
        pt_terms: List[Tuple[int, RPoint]] = []
        for eq in self.eqs:
            rho = secrets.randbelow(L - 1) + 1
            for s, ref in eq:
                c = s * rho % L
                if c == 0:
                    continue
                if isinstance(ref, (bytes, bytearray)):
                    key = bytes(ref)
                    byte_coeff[key] = (byte_coeff.get(key, 0) + c) % L
                elif isinstance(ref, RPoint):
                    pt_terms.append((c, ref))
                else:
                    gens, idx = ref
                    d = gens_coeff.setdefault(id(gens), (gens, {}))[1]
                    d[idx] = (d.get(idx, 0) + c) % L

        # one (scalars, host points) MSM; compressed points decode once
        scalars: List[int] = []
        points: List[H.HPoint] = []
        for b, c in byte_coeff.items():
            if c:
                scalars.append(c)
                points.append(H.decode(b))
        for c, p in pt_terms:
            scalars.append(c)
            points.append(p.h)
        for gens, d in gens_coeff.values():
            for idx, c in d.items():
                if c:
                    scalars.append(c)
                    points.append(gens.hh if idx == -1 else gens.Gh[idx])
        if not points:
            return True          # every equation cancelled identically
        return H.msm(scalars, points).is_identity()
