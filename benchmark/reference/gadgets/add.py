"""The point-addition gadget's assignment (vPIN_proof_generation
point_addition.rs:209-267): 15 variables an add, the affine chord rule with
the right operand's infinity flag Rz selecting P itself,

    c = 1 / (Rx - Px); s1 = (Ry - Py) c; s2 = s1^2;
    t1 = (s2 - Px - Rx)(1 - Rz); t2 = Px Rz; x3 = t1 + t2;
    s3 = s1 (Px - x3); t3 = (s3 - Py)(1 - Rz); t4 = Py Rz; y3 = t3 + t4

laid out as [c, Rx, Px, Ry, Py, Rz, s1, s2, s3, t1, t2, t3, t4, x3, y3] and
one trailing zero.  vars_para is all zero (the adds carry no model
parameters); vars_input is the whole assignment; no public inputs.

The circuit (point_addition.rs): 10 constraints an add, one a line of the
rule above, in its order, as x * y = z:

    c (Rx - Px) = 1;   (Ry - Py) c = s1;   s1 s1 = s2;
    (s2 - Px - Rx)(1 - Rz) = t1;   Px Rz = t2;   (t1 + t2) 1 = x3;
    s1 (Px - x3) = s3;   (s3 - Py)(1 - Rz) = t3;   Py Rz = t4;
    (t3 + t4) 1 = y3"""

from __future__ import annotations

from ..spartan import ELL


def shares(args):
    px, py, rx, ry, rz = args
    out = []
    for i in range(len(px)):
        p_x, p_y, r_x, r_y = (int(v) % ELL for v in (px[i], py[i], rx[i], ry[i]))
        z = int(rz[i])
        c = pow((r_x - p_x) % ELL, -1, ELL)
        s1 = (r_y - p_y) * c % ELL
        s2 = s1 * s1 % ELL
        t1 = (s2 - p_x - r_x) * (1 - z) % ELL
        t2 = p_x * z % ELL
        x3 = (t1 + t2) % ELL
        s3 = s1 * (p_x - x3) % ELL
        t3 = (s3 - p_y) * (1 - z) % ELL
        t4 = p_y * z % ELL
        y3 = (t3 + t4) % ELL
        out += [c, r_x, p_x, r_y, p_y, z, s1, s2, s3, t1, t2, t3, t4, x3, y3]
    out.append(0)
    return [0] * len(out), out, 0


def constraints(n_adds: int):
    """(rows, num_vars, num_inputs): each row the (x, y, z) of one
    constraint as {column: coefficient}, the constant 1 in column
    num_vars."""
    num_vars = 15 * n_adds + 1
    one = num_vars
    rows = []
    for k in range(n_adds):
        (c, rx, px, ry, py, rz, s1, s2, s3, t1, t2, t3, t4, x3,
         y3) = range(15 * k, 15 * k + 15)
        rows += [
            ({c: 1}, {rx: 1, px: -1}, {one: 1}),
            ({ry: 1, py: -1}, {c: 1}, {s1: 1}),
            ({s1: 1}, {s1: 1}, {s2: 1}),
            ({s2: 1, px: -1, rx: -1}, {one: 1, rz: -1}, {t1: 1}),
            ({px: 1}, {rz: 1}, {t2: 1}),
            ({t1: 1, t2: 1}, {one: 1}, {x3: 1}),
            ({s1: 1}, {px: 1, x3: -1}, {s3: 1}),
            ({s3: 1, py: -1}, {one: 1, rz: -1}, {t3: 1}),
            ({py: 1}, {rz: 1}, {t4: 1}),
            ({t3: 1, t4: 1}, {one: 1}, {y3: 1})]
    return rows, num_vars, 0
