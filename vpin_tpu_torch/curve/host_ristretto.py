"""Host-side ristretto255 (pure Python ints): the serial protocol spine.

Port of vpin_tpu/curve/host_ristretto.py, which took its constants from the
JAX device module; here they live in this module and curve/ristretto.py
imports them.  Extended-coordinate Edwards arithmetic (a = -1), RFC 9496
encode/decode and the Elligator map, as dalek's RistrettoPoint does.  Used
for generator derivation, per-round Pedersen commitments, verifier claim
combinations and every MSM at or below HOST_MSM_MAX points.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..field.prime_field import P_MODULUS

P = P_MODULUS

# --- host-side ristretto255 constants (all derived, then cross-checked
#     against the RFC 9496 values in tests) ---
D = (-121665 * pow(121666, -1, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
if SQRT_M1 % 2 == 1:
    SQRT_M1 = P - SQRT_M1          # RFC convention: constants are even ("abs")


def _sqrt_even(v: int) -> int:
    """Even square root of v mod p (p = 5 mod 8), or raise."""
    r = pow(v, (P + 3) // 8, P)
    if r * r % P != v % P:
        r = r * SQRT_M1 % P
    if r * r % P != v % P:
        raise ValueError("not a square")
    return r if r % 2 == 0 else P - r


ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P
# sqrt(a*d - 1) with a = -1.  dalek/RFC 9496 fix the ODD root here (unlike
# the other constants): 2506...235, so flip the even root.
SQRT_AD_MINUS_ONE = P - _sqrt_even((-1 * D - 1) % P)
INVSQRT_A_MINUS_D = pow(_sqrt_even((-1 - D) % P), -1, P)  # 1/sqrt(a - d)
if INVSQRT_A_MINUS_D % 2 == 1:
    INVSQRT_A_MINUS_D = P - INVSQRT_A_MINUS_D

# ed25519 basepoint
BASE_Y = 4 * pow(5, -1, P) % P
BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
RISTRETTO_BASEPOINT_COMPRESSED = bytes.fromhex(
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76")

D2 = 2 * D % P
_EXP58 = (P - 5) // 8


def _sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """RFC 9496 SQRT_RATIO_M1: (was_square, abs(+-sqrt(u/v)))."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, _EXP58, P) % P
    check = v * r % P * r % P
    u = u % P
    correct = check == u
    flipped = check == (P - u) % P
    flipped_i = check == (P - u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    if r & 1:
        r = P - r
    return (correct or flipped), r


class HPoint:
    """ristretto255 point in extended Edwards coordinates (host ints)."""

    __slots__ = ("x", "y", "z", "t")

    def __init__(self, x: int, y: int, z: int, t: int):
        self.x, self.y, self.z, self.t = x, y, z, t

    # -- group law (add-2008-hwcd-3, a = -1; complete) ------------------

    def __add__(self, q: "HPoint") -> "HPoint":
        A = (self.y - self.x) * (q.y - q.x) % P
        B = (self.y + self.x) * (q.y + q.x) % P
        C = self.t * D2 % P * q.t % P
        Dd = self.z * 2 * q.z % P
        E = B - A
        F = Dd - C
        G = Dd + C
        H = B + A
        return HPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def double(self) -> "HPoint":
        # dbl-2008-hwcd (a = -1)
        A = self.x * self.x % P
        B = self.y * self.y % P
        C = 2 * self.z % P * self.z % P
        H = A + B
        xy = self.x + self.y
        E = H - xy * xy % P
        G = A - B
        F = C + G
        return HPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def __neg__(self) -> "HPoint":
        return HPoint((P - self.x) % P, self.y, self.z, (P - self.t) % P)

    def __sub__(self, q: "HPoint") -> "HPoint":
        return self + (-q)

    def mul(self, k: int) -> "HPoint":
        """Variable-time scalar mult (verifier-style, like dalek vartime)."""
        k = int(k)
        if k < 0:
            return (-self).mul(-k)
        acc = identity()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    __mul__ = mul
    __rmul__ = mul

    def eq(self, q: "HPoint") -> bool:
        """Ristretto equality (mod torsion)."""
        return (self.x * q.y - self.y * q.x) % P == 0 or \
               (self.x * q.x - self.y * q.y) % P == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, HPoint) and self.eq(other)

    def __hash__(self):
        return hash(self.encode())

    def is_identity(self) -> bool:
        # ristretto equality with (0, 1): the coset may be represented by
        # a 4-torsion translate, so x == 0 OR y == 0 (cf. device peq)
        return self.x % P == 0 or self.y % P == 0

    # -- encode / decode (RFC 9496) -------------------------------------

    def encode(self) -> bytes:
        x0, y0, z0, t0 = self.x, self.y, self.z, self.t
        u1 = (z0 + y0) * (z0 - y0) % P
        u2 = x0 * y0 % P
        _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * t0 % P
        if (t0 * z_inv % P) & 1:                   # rotate
            x = y0 * SQRT_M1 % P
            y = x0 * SQRT_M1 % P
            den_inv = den1 * INVSQRT_A_MINUS_D % P
        else:
            x, y, den_inv = x0 % P, y0 % P, den2
        if (x * z_inv % P) & 1:
            y = (P - y) % P
        s = den_inv * (z0 - y) % P
        if s & 1:
            s = P - s
        return s.to_bytes(32, "little")


def identity() -> HPoint:
    return HPoint(0, 1, 1, 0)


def basepoint() -> HPoint:
    return HPoint(BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)


def decode(b: bytes) -> HPoint:
    """32-byte canonical encoding -> point; raises ValueError on invalid
    (same failure semantics as curve/ristretto.py decode_bytes)."""
    if len(b) != 32:
        raise ValueError("invalid ristretto encoding (length)")
    s = int.from_bytes(b, "little")
    if s >= P or s & 1:
        raise ValueError("invalid ristretto encoding (non-canonical)")
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1 % P) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = 2 * s % P * den_x % P
    if x & 1:
        x = P - x
    y = u1 * den_y % P
    t = x * y % P
    if (not was_square) or (t & 1) or y == 0:
        raise ValueError("invalid ristretto encoding (not a square)")
    return HPoint(x, y, 1, t)


def elligator(r0: int) -> HPoint:
    """RFC 9496 MAP: field element -> point (matches device elligator_map)."""
    r = SQRT_M1 * r0 % P * r0 % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = (-1 - r * D) % P * (r + D) % P
    was_square, s = _sqrt_ratio_m1(u, v)
    if was_square:
        c = P - 1
    else:
        sp = s * r0 % P
        if sp & 1:
            sp = P - sp                      # abs
        s = (P - sp) % P                     # neg(abs(s*r0))
        c = r
    N = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ % P - v) % P
    w0 = 2 * s % P * v % P
    w1 = N * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return HPoint(w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(chunk: bytes) -> HPoint:
    """dalek RistrettoPoint::from_uniform_bytes: 64 bytes -> MAP(r0)+MAP(r1)."""
    assert len(chunk) == 64
    mask = (1 << 255) - 1
    r0 = int.from_bytes(chunk[:32], "little") & mask
    r1 = int.from_bytes(chunk[32:], "little") & mask
    return elligator(r0) + elligator(r1)


# ----------------------------------------------------------------------
# host MSM (Straus for small n, Pippenger for larger)
# ----------------------------------------------------------------------

def msm(scalars: Sequence[int], points: Sequence[HPoint]) -> HPoint:
    """sum_i scalars[i] * points[i]; variable-time (verifier-style)."""
    n = len(points)
    assert len(scalars) == n
    if n == 0:
        return identity()
    if n <= 48:
        return _straus4(scalars, points)
    return _pippenger8(scalars, points)


def _straus4(scalars, points) -> HPoint:
    """Shared-doubling 4-bit windowed MSM (dalek Straus equivalent)."""
    tables = []
    for p in points:
        row = [identity(), p]
        for _ in range(14):
            row.append(row[-1] + p)
        tables.append(row)
    ss = [int(s) for s in scalars]
    nwin = max((s.bit_length() + 3) // 4 for s in ss) if any(ss) else 1
    acc = identity()
    for w in range(nwin - 1, -1, -1):
        if w != nwin - 1:
            for _ in range(4):
                acc = acc.double()
        for i, s in enumerate(ss):
            d = (s >> (4 * w)) & 0xF
            if d:
                acc = acc + tables[i][d]
    return acc


def _pippenger8(scalars, points) -> HPoint:
    """8-bit-window bucket MSM."""
    ss = [int(s) for s in scalars]
    nwin = max((s.bit_length() + 7) // 8 for s in ss) if any(ss) else 1
    acc = identity()
    for w in range(nwin - 1, -1, -1):
        if w != nwin - 1:
            for _ in range(8):
                acc = acc.double()
        buckets: List[HPoint] = [None] * 256
        for s, p in zip(ss, points):
            d = (s >> (8 * w)) & 0xFF
            if d:
                buckets[d] = p if buckets[d] is None else buckets[d] + p
        running = None
        total = None
        for d in range(255, 0, -1):
            if buckets[d] is not None:
                running = buckets[d] if running is None else running + buckets[d]
            if running is not None:
                total = running if total is None else total + running
        if total is not None:
            acc = acc + total
    return acc
