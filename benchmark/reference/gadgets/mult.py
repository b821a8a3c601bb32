"""The point-multiplication gadget's assignment (vPIN_proof_generation
point_mult.rs:85-343, 517-573): Q = a P by double-and-add over the n = 128
bits of the scalar a, least significant first, 27n + 10 variables a mult.

State before bit i: A_i = 2^i P (A_0 = P) and the partial sum
B_i = (sum of 2^k P over the set bits k < i), with Bz_i = 1 while that sum
is still the point at infinity (B_0 = (0, 0, 1)).  Bit i takes:

  addition, C = B + A (chord rule; with Bz = 1, C = A):
    c = 1 / (Bx - Ax); s1 = (By - Ay) c; s2 = s1^2;
    t1 = (s2 - Ax - Bx)(1 - Bz); t2 = Ax Bz; Cx = t1 + t2;
    s3 = s1 (Ax - Cx); t3 = (s3 - Ay)(1 - Bz); t4 = Ay Bz; Cy = t3 + t4
  doubling, D = 2 A (tangent rule with E2's curve parameter a, the
  instance's one public input):
    c' = 1 / (2 Ay); t1' = Ax^2; s1' = (3 t1' + a) c'; s2' = s1'^2;
    Dx = s2' - 2 Ax; t2' = s1' (Ax - Dx); Dy = t2' - Ay
  the mux on the bit b:
    z1 = Cx b; z2 = Bx (1 - b); z3 = Cy b; z4 = By (1 - b);
    B_{i+1} = (z1 + z2, z3 + z4, Bz (1 - b)); A_{i+1} = D

and Q = B_n.  A mult's block of variables:

  [0, n)            the bits b_0 .. b_{n-1}
  n                 a
  n + 1 + k         Ax_k, k = 0..n      (so n + 1 entries each, in turn:)
  2n + 2 + k        Ay_k
  3n + 3 + k        Bx_k
  4n + 4 + k        By_k
  5n + 5 + k        Bz_k
  6n + 6 + i        Cx_i, then Cy_i, Dx_i, Dy_i (n entries each)
  10n + 6 .. 10n + 9  Qx, Qy, Px, Py
  10n + 10 + i      c, s1, s2, s3, t1, t2, t3, t4 of the addition, then
                    c', t1', s1', s2', t2' of the doubling, then z1 .. z4
                    (n entries each, 17 groups: up to 27n + 10)

The blocks follow one another, then one trailing zero.  vars_para holds
each scalar a at its slot n + (27n + 10) j and zero elsewhere; vars_input
is the whole assignment with those slots zeroed; one public input (E2's a).
An inverse of zero is zero, as the field's a^(l - 2) gives it.

The circuit: 27n + 8 constraints a mult, as x * y = z, in this order:
  (sum 2^i b_i) 1 = a;  b_i b_i = b_i for each bit;
  (Ax_0 - Px) 1 = 0;  (Ay_0 - Py) 1 = 0;  Bx_0 1 = 0;  By_0 1 = 0;
  (Bz_0 - 1) 1 = 0;
  for each bit, 26 rows: the addition's ten, c (Bx - Ax) = 1, then as
  point_addition's with (A, B) in place of (P, R); the doubling's seven,
    c' (2 Ay) = 1;  Ax Ax = t1';  (3 t1' + a) c' = s1';  s1' s1' = s2';
    (s2' - 2 Ax) 1 = Dx;  s1' (Ax - Dx) = t2';  (t2' - Ay) 1 = Dy;
  the mux's nine,
    Cx b = z1;  Bx (1 - b) = z2;  (z1 + z2) 1 = Bx_{i+1};  Cy b = z3;
    By (1 - b) = z4;  (z3 + z4) 1 = By_{i+1};  Bz (1 - b) = Bz_{i+1};
    (Ax_{i+1} - Dx) 1 = 0;  (Ay_{i+1} - Dy) 1 = 0;
  (Qx - Bx_n) 1 = 0;  (Qy - By_n) 1 = 0."""

from __future__ import annotations

from ..e2 import A as E2_A
from ..spartan import ELL

#: the bits of a scalar (the configurations' n_bits)
N = 128


def _inv(v: int) -> int:
    return pow(v, -1, ELL) if v % ELL else 0


def block(a: int, px: int, py: int):
    """One mult's 27n + 10 variables, in the layout above."""
    if not 0 <= a < 1 << N:
        raise ValueError(f"scalar {a} exceeds {N} bits")
    bits = [(a >> k) & 1 for k in range(N)]
    ax, ay, bx, by, bz = px, py, 0, 0, 1
    A = ([ax], [ay], [bx], [by], [bz])
    cols = [[] for _ in range(4 + 17)]     # Cx, Cy, Dx, Dy, then 17 groups
    for b in bits:
        c = _inv(bx - ax)
        s1 = (by - ay) * c % ELL
        s2 = s1 * s1 % ELL
        t1 = (s2 - ax - bx) * (1 - bz) % ELL
        t2 = ax * bz % ELL
        cx = (t1 + t2) % ELL
        s3 = s1 * (ax - cx) % ELL
        t3 = (s3 - ay) * (1 - bz) % ELL
        t4 = ay * bz % ELL
        cy = (t3 + t4) % ELL
        cd = _inv(2 * ay)
        t1d = ax * ax % ELL
        s1d = (3 * t1d + E2_A) * cd % ELL
        s2d = s1d * s1d % ELL
        dx = (s2d - 2 * ax) % ELL
        t2d = s1d * (ax - dx) % ELL
        dy = (t2d - ay) % ELL
        z1, z2 = cx * b % ELL, bx * (1 - b) % ELL
        z3, z4 = cy * b % ELL, by * (1 - b) % ELL
        ax, ay = dx, dy
        bx, by, bz = (z1 + z2) % ELL, (z3 + z4) % ELL, bz * (1 - b) % ELL
        for col, v in zip(A, (ax, ay, bx, by, bz)):
            col.append(v)
        for col, v in zip(cols, (cx, cy, dx, dy, c, s1, s2, s3, t1, t2, t3,
                                 t4, cd, t1d, s1d, s2d, t2d, z1, z2, z3, z4)):
            col.append(v)
    out = bits + [a]
    for col in A:
        out += col
    out += cols[0] + cols[1] + cols[2] + cols[3]
    out += [bx, by, px, py]
    for col in cols[4:]:
        out += col
    if len(out) != 27 * N + 10:
        raise AssertionError(f"block of {len(out)} variables")
    return out


def shares(args):
    scalars, px, py = args
    onv = 27 * N + 10
    full = []
    for a, x, y in zip(scalars, px, py):
        full += block(int(a), int(x) % ELL, int(y) % ELL)
    full.append(0)
    para = [0] * len(full)
    for j, a in enumerate(scalars):
        para[N + onv * j] = int(a)
        full[N + onv * j] = 0
    return para, full, 1


def constraints(n_mults: int):
    """(rows, num_vars, num_inputs): each row the (x, y, z) of one
    constraint as {column: coefficient}, the constant 1 in column num_vars
    and the input a after it."""
    onv = 27 * N + 10
    num_vars = onv * n_mults + 1
    one, a_in = num_vars, num_vars + 1
    rows = []
    for j in range(n_mults):
        v = onv * j

        def at(base):
            return lambda k: v + base + k
        b, Ax, Ay, Bx, By, Bz = (at(0), at(N + 1), at(2 * N + 2),
                                 at(3 * N + 3), at(4 * N + 4), at(5 * N + 5))
        Cx, Cy, Dx, Dy = (at(6 * N + 6), at(7 * N + 6), at(8 * N + 6),
                          at(9 * N + 6))
        a, qx, qy, px, py = (v + N, v + 10 * N + 6, v + 10 * N + 7,
                             v + 10 * N + 8, v + 10 * N + 9)
        (c, s1, s2, s3, t1, t2, t3, t4, cd, t1d, s1d, s2d, t2d, z1, z2, z3,
         z4) = (at(10 * N + 10 + g * N) for g in range(17))
        rows.append(({b(i): 1 << i for i in range(N)}, {one: 1}, {a: 1}))
        rows += [({b(i): 1}, {b(i): 1}, {b(i): 1}) for i in range(N)]
        rows += [({Ax(0): 1, px: -1}, {one: 1}, {}),
                 ({Ay(0): 1, py: -1}, {one: 1}, {}),
                 ({Bx(0): 1}, {one: 1}, {}),
                 ({By(0): 1}, {one: 1}, {}),
                 ({Bz(0): 1, one: -1}, {one: 1}, {})]
        for i in range(N):
            ax, ay, bx, by, bz, bi = Ax(i), Ay(i), Bx(i), By(i), Bz(i), b(i)
            rows += [
                ({c(i): 1}, {bx: 1, ax: -1}, {one: 1}),
                ({by: 1, ay: -1}, {c(i): 1}, {s1(i): 1}),
                ({s1(i): 1}, {s1(i): 1}, {s2(i): 1}),
                ({s2(i): 1, ax: -1, bx: -1}, {one: 1, bz: -1}, {t1(i): 1}),
                ({ax: 1}, {bz: 1}, {t2(i): 1}),
                ({t1(i): 1, t2(i): 1}, {one: 1}, {Cx(i): 1}),
                ({s1(i): 1}, {ax: 1, Cx(i): -1}, {s3(i): 1}),
                ({s3(i): 1, ay: -1}, {one: 1, bz: -1}, {t3(i): 1}),
                ({ay: 1}, {bz: 1}, {t4(i): 1}),
                ({t3(i): 1, t4(i): 1}, {one: 1}, {Cy(i): 1}),
                ({cd(i): 1}, {ay: 2}, {one: 1}),
                ({ax: 1}, {ax: 1}, {t1d(i): 1}),
                ({t1d(i): 3, a_in: 1}, {cd(i): 1}, {s1d(i): 1}),
                ({s1d(i): 1}, {s1d(i): 1}, {s2d(i): 1}),
                ({s2d(i): 1, ax: -2}, {one: 1}, {Dx(i): 1}),
                ({s1d(i): 1}, {ax: 1, Dx(i): -1}, {t2d(i): 1}),
                ({t2d(i): 1, ay: -1}, {one: 1}, {Dy(i): 1}),
                ({Cx(i): 1}, {bi: 1}, {z1(i): 1}),
                ({bx: 1}, {one: 1, bi: -1}, {z2(i): 1}),
                ({z1(i): 1, z2(i): 1}, {one: 1}, {Bx(i + 1): 1}),
                ({Cy(i): 1}, {bi: 1}, {z3(i): 1}),
                ({by: 1}, {one: 1, bi: -1}, {z4(i): 1}),
                ({z3(i): 1, z4(i): 1}, {one: 1}, {By(i + 1): 1}),
                ({bz: 1}, {one: 1, bi: -1}, {Bz(i + 1): 1}),
                ({Ax(i + 1): 1, Dx(i): -1}, {one: 1}, {}),
                ({Ay(i + 1): 1, Dy(i): -1}, {one: 1}, {})]
        rows += [({qx: 1, Bx(N): -1}, {one: 1}, {}),
                 ({qy: 1, By(N): -1}, {one: 1}, {})]
    return rows, num_vars, 1
