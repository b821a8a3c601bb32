"""A Spartan CP-SNARK's witness commitments, recomputed in plain Python:
ristretto255 over Python ints (RFC 9496), STROBE-128 and merlin transcripts
over a plain Keccak-f[1600], the Pedersen generators and the Hyrax rows.

A point-add or point-mult CP-SNARK (vPIN_proof_generation
proof_point_add.rs:44-78, Spartan dense_mlpoly.rs) commits its witness in
two shares, vars_para and vars_input, each as the rows of a
2^lnv x 2^rnv matrix: row r is <row, G> + blind_r * h.  The blinds come
from the prover's random tape, a merlin transcript named b"\\x02" seeded
with the proof's tape seed: 2^lnv draws labelled b"poly_blinds" for
vars_para, then as many for vars_input.  The verifier checks the proof
against these commitments, so commitments recomputed from the reference's
own witness tie a proof that verifies to the witness it has to be of.
``rows_at_fault`` compares them through one random linear combination of
the rows (two MSMs of a row's width a share).  ``instance`` builds the
R1CS instance the proofs have to be verified against, padded as Spartan
pads it, so that a proof of a weaker circuit is caught too.

Each gadget is a module of its own, found by the gadget's name:
benchmark/reference/gadgets/<name>.py with ``shares(args)`` (the witness
layout) and ``constraints(count)`` (the circuit).
"""

from __future__ import annotations

import functools
import hashlib
import importlib
import random
from typing import Dict, List, Sequence, Tuple

# ------------------------------------------------------------ Keccak-f[1600]

_MASK64 = (1 << 64) - 1


def _rol(a: int, n: int) -> int:
    n %= 64
    return ((a << n) | (a >> (64 - n))) & _MASK64 if n else a


def keccak_f1600(state: bytearray) -> None:
    """The permutation on a 200-byte state, in place (FIPS 202)."""
    lanes = [[int.from_bytes(state[8 * (x + 5 * y):8 * (x + 5 * y) + 8],
                             "little") for y in range(5)] for x in range(5)]
    R = 1
    for _ in range(24):
        C = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3]
             ^ lanes[x][4] for x in range(5)]
        D = [C[(x + 4) % 5] ^ _rol(C[(x + 1) % 5], 1) for x in range(5)]
        lanes = [[lanes[x][y] ^ D[x] for y in range(5)] for x in range(5)]
        x, y = 1, 0
        cur = lanes[x][y]
        for t in range(24):
            x, y = y, (2 * x + 3 * y) % 5
            cur, lanes[x][y] = lanes[x][y], _rol(cur, (t + 1) * (t + 2) // 2)
        for y in range(5):
            T = [lanes[x][y] for x in range(5)]
            for x in range(5):
                lanes[x][y] = T[x] ^ (~T[(x + 1) % 5] & T[(x + 2) % 5])
        for j in range(7):
            R = ((R << 1) ^ ((R >> 7) * 0x71)) % 256
            if R & 2:
                lanes[0][0] ^= 1 << ((1 << j) - 1)
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y):8 * (x + 5 * y) + 8] = \
                lanes[x][y].to_bytes(8, "little")


# ------------------------------------------------------ STROBE-128, merlin

_RATE = 166
_I, _A, _C, _M = 1, 2, 4, 16


class Strobe:
    """The subset of STROBE-128 that merlin uses (meta-AD, AD, PRF)."""

    def __init__(self, label: bytes):
        self.st = bytearray(200)
        self.st[0:6] = bytes([1, _RATE + 2, 1, 0, 1, 96])
        self.st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(self.st)
        self.pos = self.begin = self.flags = 0
        self.meta_ad(label, False)

    def _f(self):
        self.st[self.pos] ^= self.begin
        self.st[self.pos + 1] ^= 0x04
        self.st[_RATE + 1] ^= 0x80
        keccak_f1600(self.st)
        self.pos = self.begin = 0

    def _absorb(self, data: bytes):
        for b in data:
            self.st[self.pos] ^= b
            self.pos += 1
            if self.pos == _RATE:
                self._f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.st[self.pos])
            self.st[self.pos] = 0
            self.pos += 1
            if self.pos == _RATE:
                self._f()
        return bytes(out)

    def _op(self, flags: int, more: bool):
        if more:
            assert flags == self.flags
            return
        old, self.begin, self.flags = self.begin, self.pos + 1, flags
        self._absorb(bytes([old, flags]))
        if flags & _C and self.pos != 0:
            self._f()

    def meta_ad(self, data: bytes, more: bool):
        self._op(_M | _A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._op(_A, more)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._op(_I | _A | _C, False)
        return self._squeeze(n)


class Transcript:
    """A merlin transcript, with Spartan's scalar helpers."""

    def __init__(self, label: bytes):
        self.s = Strobe(b"Merlin v1.0")
        self.append(b"dom-sep", label)

    def append(self, label: bytes, msg: bytes):
        self.s.meta_ad(label, False)
        self.s.meta_ad(len(msg).to_bytes(4, "little"), True)
        self.s.ad(msg, False)

    def challenge(self, label: bytes, n: int) -> bytes:
        self.s.meta_ad(label, False)
        self.s.meta_ad(n.to_bytes(4, "little"), True)
        return self.s.prf(n)

    def scalar(self, label: bytes) -> int:
        return int.from_bytes(self.challenge(label, 64), "little") % ELL


def tape_blinds(tape_seed: int, counts: Sequence[int]) -> List[List[int]]:
    """The blinds a random tape named b"\\x02" and seeded with
    ``tape_seed`` gives: one vector a count, drawn in turn."""
    t = Transcript(bytes([2]))
    t.append(b"init_randomness", (tape_seed % ELL).to_bytes(32, "little"))
    return [[t.scalar(b"poly_blinds") for _ in range(n)] for n in counts]


# ------------------------------------------------------------- ristretto255

PP = 2 ** 255 - 19
ELL = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, -1, PP) % PP
SQRT_M1 = 19681161376707505956807079304988542015446066515923890162744021073123829784752
INVSQRT_A_MINUS_D = 54469307008909316920995813868745141605393597292927456921205312896311721017578
SQRT_AD_MINUS_ONE = 25063068953384623474111414158702152701244531502492656460079210482610430750235
ONE_MINUS_D_SQ = 1159843021668779879193775521855586647937357759715417654439879720876111806838
D_MINUS_ONE_SQ = 40440834346308536858101042469323190826248399146238708352240133220865137265952
BASE = (15112221349535400772501151409588531511454012693041857206046113283949847762202,
        46316835694926478169428394003475163141307993866256225615783033603165251855960)
ZERO = (0, 1, 1, 0)


def _neg(v: int) -> bool:
    return bool(v % PP & 1)


def _abs(v: int) -> int:
    v %= PP
    return PP - v if v & 1 else v


def _sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """RFC 9496 SQRT_RATIO_M1."""
    r = u * pow(v, 3, PP) * pow(u * pow(v, 7, PP), (PP - 5) // 8, PP) % PP
    check = v * r * r % PP
    u %= PP
    ok, flip, flip_i = (check == u, check == -u % PP,
                        check == -u * SQRT_M1 % PP)
    if flip or flip_i:
        r = r * SQRT_M1 % PP
    return ok or flip, _abs(r)


def add(p, q):
    """Extended Edwards coordinates, a = -1 (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % PP
    b = (y1 + x1) * (y2 + x2) % PP
    c = 2 * D * t1 * t2 % PP
    d = 2 * z1 * z2 % PP
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % PP, g * h % PP, f * g % PP, e * h % PP)


def window_table(p) -> List[tuple]:
    """0 * p, 1 * p, ..., 15 * p."""
    row = [ZERO, p]
    for _ in range(14):
        row.append(add(row[-1], p))
    return row


def msm(scalars: Sequence[int], tables: Sequence[List[tuple]]) -> tuple:
    """sum_i scalars[i] * p_i from the points' window tables, 4-bit
    windows, doublings shared."""
    ks = [int(k) % ELL for k in scalars]
    acc = ZERO
    for w in range(63, -1, -1):
        for _ in range(4):
            acc = add(acc, acc)
        for k, row in zip(ks, tables):
            d = (k >> (4 * w)) & 15
            if d:
                acc = add(acc, row[d])
    return acc


def encode(p) -> bytes:
    """RFC 9496 ENCODE."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % PP
    u2 = x0 * y0 % PP
    _, inv = _sqrt_ratio_m1(1, u1 * u2 * u2)
    den1, den2 = inv * u1 % PP, inv * u2 % PP
    z_inv = den1 * den2 * t0 % PP
    if _neg(t0 * z_inv):
        x, y, den_inv = y0 * SQRT_M1 % PP, x0 * SQRT_M1 % PP, \
            den1 * INVSQRT_A_MINUS_D % PP
    else:
        x, y, den_inv = x0, y0, den2
    if _neg(x * z_inv):
        y = -y
    return _abs(den_inv * (z0 - y)).to_bytes(32, "little")


def decode(b: bytes):
    """RFC 9496 DECODE: the point of a canonical encoding, or None where
    the 32 bytes encode no point."""
    s = int.from_bytes(b, "little")
    if len(b) != 32 or s >= PP or _neg(s):
        return None
    ss = s * s % PP
    u1, u2 = (1 - ss) % PP, (1 + ss) % PP
    u2_sqr = u2 * u2 % PP
    v = (-(D * u1 * u1) - u2_sqr) % PP
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr)
    den_x = invsqrt * u2 % PP
    den_y = invsqrt * den_x * v % PP
    x = _abs(2 * s * den_x)
    y = u1 * den_y % PP
    t = x * y % PP
    if not was_square or _neg(t) or y == 0:
        return None
    return (x, y, 1, t)


def _map(t: int):
    """RFC 9496 MAP (Elligator 2)."""
    r = SQRT_M1 * t * t % PP
    u = (r + 1) * ONE_MINUS_D_SQ % PP
    v = (-1 - r * D) * (r + D) % PP
    square, s = _sqrt_ratio_m1(u, v)
    if square:
        c = -1
    else:
        s, c = -_abs(s * t) % PP, r
    n = (c * (r - 1) * D_MINUS_ONE_SQ - v) % PP
    w0, w1 = 2 * s * v % PP, n * SQRT_AD_MINUS_ONE % PP
    w2, w3 = (1 - s * s) % PP, (1 + s * s) % PP
    return (w0 * w3 % PP, w2 * w1 % PP, w1 * w3 % PP, w0 * w2 % PP)


def from_uniform_bytes(b: bytes):
    low = (1 << 255) - 1
    return add(_map(int.from_bytes(b[:32], "little") & low),
               _map(int.from_bytes(b[32:], "little") & low))


def basepoint():
    x, y = BASE
    return (x, y, 1, x * y % PP)


def generators(n: int, label: bytes) -> Tuple[List[tuple], tuple]:
    """Spartan's PolyCommitmentGens for rows of n: MultiCommitGens::new(
    n + 1, label) (n + 2 points from SHAKE256(label || the compressed
    basepoint), one-way map) split after n: the row generators G and the
    blinding generator h, the last point."""
    shake = hashlib.shake_256(label + encode(basepoint()))
    stream = shake.digest(64 * (n + 2))
    pts = [from_uniform_bytes(stream[64 * i:64 * i + 64])
           for i in range(n + 2)]
    return pts[:n], pts[n + 1]


# ------------------------------------------------------------------ Hyrax


def shape(num_vars: int, num_inputs: int) -> Tuple[int, int]:
    """(rows, row length) of the witness matrix: the padded variable count
    2^ell (SNARKGens) split as 2^(ell//2) x 2^(ell - ell//2)."""
    n = max(num_vars, num_inputs + 1)
    n = 1 << (n - 1).bit_length()
    ell = n.bit_length() - 1
    return 1 << (ell // 2), 1 << (ell - ell // 2)


@functools.lru_cache(maxsize=None)
def _row_tables(width: int, label: bytes):
    G, h = generators(width, label)
    return [window_table(g) for g in G], window_table(h)


def layout(gadget: str):
    """benchmark/reference/gadgets/<gadget>.py; ModuleNotFoundError for a
    gadget the reference cannot commit."""
    return importlib.import_module(f"{__package__}.gadgets.{gadget}")


def _witness(gadget: str, args, tape_seed: int):
    """The shares of ``args`` with their blinds, the row count and the sat
    proof's row generators (R1CSGens, label b"gens_r1cs_sat")."""
    para, inp, num_inputs = layout(gadget).shares(args)
    rows, width = shape(len(inp), num_inputs)
    G, h = _row_tables(width, b"gens_r1cs_sat")
    b_para, b_inp = tape_blinds(tape_seed, [rows, rows])
    return ((para, b_para), (inp, b_inp)), rows, G, h


def rows_combine(values: Sequence[int], blinds: Sequence[int],
                 got: Sequence[bytes], coeffs: Sequence[int], G, h) -> bool:
    """Whether the rows ``got`` are the commitments of ``values`` (rows of
    len(G), zero-padded) with ``blinds``, checked through one random linear
    combination: sum c_r C_r over the decoded rows against
    <sum c_r v_r, G> + (sum c_r b_r) h.  Exact group arithmetic: rows that
    differ anywhere pass only where the coefficients cancel the difference
    (probability about 2^-128 for 128-bit coefficients).  A row that does
    not decode, or a row count other than the blinds', fails."""
    rows, width = len(blinds), len(G)
    if len(got) != rows:
        return False
    points = [decode(bytes(c)) for c in got]
    if any(p is None for p in points):
        return False
    lhs = msm(coeffs, [window_table(p) for p in points])
    row = [0] * width
    for r, c in enumerate(coeffs):
        for k, v in enumerate(values[r * width:(r + 1) * width]):
            if v:
                row[k] += c * v
    blind = sum(c * b for c, b in zip(coeffs, blinds))
    pick = [(v % ELL, g) for v, g in zip(row, G) if v % ELL]
    rhs = msm([v for v, _ in pick] + [blind],
              [g for _, g in pick] + [h])
    return encode(lhs) == encode(rhs)


def rows_at_fault(gadget: str, args, tape_seed: int, got_para, got_input,
                  seed: int) -> bool:
    """Whether the row commitments a proof was verified against (para,
    input) differ from those of the reference's witness ``args`` with the
    blinds of ``tape_seed``: rows_combine on each share, with 128-bit
    coefficients drawn from random.Random(seed), the para rows' first."""
    shares, rows, G, h = _witness(gadget, args, tape_seed)
    rng = random.Random(seed)
    return not all(
        rows_combine(values, blinds, got,
                     [rng.getrandbits(128) for _ in range(rows)], G, h)
        for (values, blinds), got in ((shares[0], got_para),
                                      (shares[1], got_input)))


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=4)
def instance(gadget: str, count: int):
    """(num_cons, num_vars, num_inputs, A, B, C) of the instance that the
    proofs of ``count`` operations of ``gadget`` are verified against, as
    Spartan's Instance::new pads the circuit: both counts up to powers of
    two, and the columns of the constant 1 and the inputs moved up to
    follow the padded variables.  A, B and C are sorted (row, column,
    value mod l) triples with no zero value."""
    rows, num_vars, num_inputs = layout(gadget).constraints(count)
    nv = _pow2(max(num_vars, num_inputs + 1))
    mats = tuple(
        tuple(sorted((r, c + nv - num_vars if c >= num_vars else c, v % ELL)
                     for r, row in enumerate(rows)
                     for c, v in row[side].items() if v % ELL))
        for side in range(3))
    return (_pow2(max(len(rows), 2)), nv, num_inputs) + mats


def canonical(num_cons: int, num_vars: int, num_inputs: int, mats):
    """An instance given as its counts and (rows, cols, values) of A, B
    and C in the form ``instance`` returns: entries of one place summed."""
    out = []
    for rows, cols, vals in mats:
        acc: Dict[Tuple[int, int], int] = {}
        for r, c, v in zip(rows, cols, vals):
            acc[r, c] = (acc.get((r, c), 0) + int(v)) % ELL
        out.append(tuple(sorted((r, c, v) for (r, c), v in acc.items()
                                if v)))
    return (int(num_cons), int(num_vars), int(num_inputs)) + tuple(out)
