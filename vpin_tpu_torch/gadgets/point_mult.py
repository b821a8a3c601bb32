"""Point-multiplication R1CS gadget: double-and-add circuit, 27n+8
constraints / 27n+10 variables per mult (n = 128 scalar bits).

Port of vpin_tpu/gadgets/point_mult.py, constraint-index-compatible with the
reference circuit (vPIN_proof_generation/src/point_mult.rs:85-343):
  * bit recomposition sum 2^i b_i = a, booleanity, initial-state pinning;
  * per bit i: the 10-constraint PA gadget (C_i = B_i + A_i), the
    7-constraint PD gadget (D_i = 2*A_i, using the public curve parameter
    a as the single circuit input), and a 9-constraint bit-mux updating
    (B, A);
  * final Qx/Qy pinning.

The variable-block layout (stride 27n+10) and the para/input witness split
(vars_para = the scalars a_j only; point_mult.rs:517-573) are preserved.
The witness trace is a loop over the n bit-steps of batched tensor ops, all
multiplications in the batch advancing together.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..curve.host_ec import E2_A
from ..device import resolve_device
from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..snark.r1cs import R1CSInstance
from ..utils.timer import span

M1 = L - 1
M2 = L - 2
N_BITS_DEFAULT = 128

# the reference's hard-coded a_pd byte constant is curve E2's a
_A_PD_BYTES = bytes([157, 27, 50, 101, 63, 42, 38, 142, 68, 159, 245, 15, 16,
                     47, 75, 58, 203, 87, 15, 3, 219, 183, 77, 94, 64, 118,
                     147, 233, 124, 16, 184, 7])
if int.from_bytes(_A_PD_BYTES, "little") != E2_A:
    raise AssertionError("reference a_pd constant should be curve E2's a")


def nnz_param(n_mults: int, n: int = N_BITS_DEFAULT) -> int:
    """Hard-coded nnz bucket table (reference point_mult.rs:29-56)."""
    m = n_mults
    if m == 50:
        p = (100, 2, 80)
    elif m == 210:
        p = (300, 2, 20)
    elif m == 240:
        p = (300, 4, 20)
    elif m < 660:
        p = (100, 2, 40)
    elif m == 6000:
        p = (250, 2, 20)
    else:
        p = (350, 2, 20)
    return p[0] * ((p[1] * n) + (p[2] * m))


# per-bit constraint templates: (mat, row_off_k, [(col_base, val)...])
# col_base uses symbols: int => block offset + i; ("abs", x) => absolute.
def _templates(n: int, ONE: int, INP: int):
    T = []

    def t(k, a_entries, b_entries, c_entries):
        T.append((k, a_entries, b_entries, c_entries))

    # PA
    t(0, [(10 * n + 10, 1)], [(3 * n + 3, 1), (n + 1, M1)], [(("abs", ONE), 1)])
    t(1, [(4 * n + 4, 1), (2 * n + 2, M1)], [(10 * n + 10, 1)], [(11 * n + 10, 1)])
    t(2, [(11 * n + 10, 1)], [(11 * n + 10, 1)], [(12 * n + 10, 1)])
    t(3, [(12 * n + 10, 1), (n + 1, M1), (3 * n + 3, M1)],
      [(("abs", ONE), 1), (5 * n + 5, M1)], [(14 * n + 10, 1)])
    t(4, [(n + 1, 1)], [(5 * n + 5, 1)], [(15 * n + 10, 1)])
    t(5, [(14 * n + 10, 1), (15 * n + 10, 1)], [(("abs", ONE), 1)], [(6 * n + 6, 1)])
    t(6, [(11 * n + 10, 1)], [(n + 1, 1), (6 * n + 6, M1)], [(13 * n + 10, 1)])
    t(7, [(13 * n + 10, 1), (2 * n + 2, M1)],
      [(("abs", ONE), 1), (5 * n + 5, M1)], [(16 * n + 10, 1)])
    t(8, [(2 * n + 2, 1)], [(5 * n + 5, 1)], [(17 * n + 10, 1)])
    t(9, [(16 * n + 10, 1), (17 * n + 10, 1)], [(("abs", ONE), 1)], [(7 * n + 6, 1)])
    # PD
    t(10, [(18 * n + 10, 1)], [(2 * n + 2, 2)], [(("abs", ONE), 1)])
    t(11, [(n + 1, 1)], [(n + 1, 1)], [(19 * n + 10, 1)])
    t(12, [(19 * n + 10, 3), (("abs", INP), 1)], [(18 * n + 10, 1)], [(20 * n + 10, 1)])
    t(13, [(20 * n + 10, 1)], [(20 * n + 10, 1)], [(21 * n + 10, 1)])
    t(14, [(21 * n + 10, 1), (n + 1, M2)], [(("abs", ONE), 1)], [(8 * n + 6, 1)])
    t(15, [(20 * n + 10, 1)], [(n + 1, 1), (8 * n + 6, M1)], [(22 * n + 10, 1)])
    t(16, [(22 * n + 10, 1), (2 * n + 2, M1)], [(("abs", ONE), 1)], [(9 * n + 6, 1)])
    # mux
    t(17, [(6 * n + 6, 1)], [(0, 1)], [(23 * n + 10, 1)])
    t(18, [(3 * n + 3, 1)], [(("abs", ONE), 1), (0, M1)], [(24 * n + 10, 1)])
    t(19, [(23 * n + 10, 1), (24 * n + 10, 1)], [(("abs", ONE), 1)], [(3 * n + 4, 1)])
    t(20, [(7 * n + 6, 1)], [(0, 1)], [(25 * n + 10, 1)])
    t(21, [(4 * n + 4, 1)], [(("abs", ONE), 1), (0, M1)], [(26 * n + 10, 1)])
    t(22, [(25 * n + 10, 1), (26 * n + 10, 1)], [(("abs", ONE), 1)], [(4 * n + 5, 1)])
    t(23, [(5 * n + 5, 1)], [(("abs", ONE), 1), (0, M1)], [(5 * n + 6, 1)])
    t(24, [(n + 2, 1), (8 * n + 6, M1)], [(("abs", ONE), 1)], [])
    t(25, [(2 * n + 3, 1), (9 * n + 6, M1)], [(("abs", ONE), 1)], [])
    return T


def build_matrices(n_mults: int, n: int = N_BITS_DEFAULT):
    onc = 27 * n + 8
    onv = 27 * n + 10
    num_vars = onv * n_mults + 1
    num_inputs = 1
    ONE = num_vars
    INP = num_vars + 1
    N = n_mults

    j = np.arange(N, dtype=np.int64)
    i = np.arange(n, dtype=np.int64)
    rowj = onc * j       # (N,)
    varj = onv * j

    A_parts, B_parts, C_parts = [], [], []

    def add_ji(parts, rows, cols, vals):
        parts.append((rows.reshape(-1), cols.reshape(-1),
                      np.asarray(vals, dtype=object).reshape(-1)))

    # constraint 0: sum 2^i b_i = a
    pow2 = np.array([pow(2, int(k), L) for k in range(n)], dtype=object)
    add_ji(A_parts, np.broadcast_to(rowj[:, None], (N, n)).copy(),
           varj[:, None] + i[None, :],
           np.broadcast_to(pow2[None, :], (N, n)).copy())
    add_ji(B_parts, rowj, np.full(N, ONE, np.int64), np.ones(N, dtype=object))
    add_ji(C_parts, rowj, varj + n, np.ones(N, dtype=object))

    # constraints 1..n: booleanity b*b = b
    rows_b = rowj[:, None] + (i[None, :] + 1)
    cols_b = varj[:, None] + i[None, :]
    ones_ji = np.ones((N, n), dtype=object)
    for parts in (A_parts, B_parts, C_parts):
        add_ji(parts, rows_b.copy(), cols_b.copy(), ones_ji)

    # init pinning n+1..n+5
    def pin(row_off, a_entries):
        for col_off, val in a_entries:
            if col_off == "ONE":
                add_ji(A_parts, rowj + row_off, np.full(N, ONE, np.int64),
                       np.full(N, val, dtype=object))
            else:
                add_ji(A_parts, rowj + row_off, varj + col_off,
                       np.full(N, val, dtype=object))
        add_ji(B_parts, rowj + row_off, np.full(N, ONE, np.int64),
               np.ones(N, dtype=object))

    pin(n + 1, [(n + 1, 1), (10 * n + 8, M1)])          # Ax0 = Px
    pin(n + 2, [(2 * n + 2, 1), (10 * n + 9, M1)])      # Ay0 = Py
    pin(n + 3, [(3 * n + 3, 1)])                        # Bx0 = 0
    pin(n + 4, [(4 * n + 4, 1)])                        # By0 = 0
    pin(n + 5, [(5 * n + 5, 1), ("ONE", M1)])           # Bz0 = 1

    # per-bit template constraints
    for k, a_e, b_e, c_e in _templates(n, ONE, INP):
        rows = rowj[:, None] + (n + 6 + 26 * i[None, :] + k)
        for parts, entries in ((A_parts, a_e), (B_parts, b_e), (C_parts, c_e)):
            for col, val in entries:
                if isinstance(col, tuple):
                    cols = np.full((N, n), col[1], np.int64)
                else:
                    cols = varj[:, None] + (col + i[None, :])
                add_ji(parts, rows.copy(), cols,
                       np.full((N, n), val, dtype=object))

    # final pinning
    add_ji(A_parts, rowj + onc - 2, varj + 10 * n + 6, np.ones(N, dtype=object))
    add_ji(A_parts, rowj + onc - 2, varj + 4 * n + 3, np.full(N, M1, dtype=object))
    add_ji(B_parts, rowj + onc - 2, np.full(N, ONE, np.int64), np.ones(N, dtype=object))
    add_ji(A_parts, rowj + onc - 1, varj + 10 * n + 7, np.ones(N, dtype=object))
    add_ji(A_parts, rowj + onc - 1, varj + 5 * n + 4, np.full(N, M1, dtype=object))
    add_ji(B_parts, rowj + onc - 1, np.full(N, ONE, np.int64), np.ones(N, dtype=object))

    def flatten(parts):
        rows = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        vals = np.concatenate([p[2] for p in parts])
        return (rows, cols, vals)          # array triple (SparseMat-native)

    return (flatten(A_parts), flatten(B_parts), flatten(C_parts),
            onc * N, num_vars, num_inputs)


def _mult_witness_scan(px, py, bits_f):
    """Batched double-and-add witness: bits_f (N, n, 8) field elements
    (0/1 in Montgomery form).  Returns the per-step traces, each stacked
    to (N, n, 8), in the reference scan's output order."""
    dev = px.device
    one = FQ.ones(px.shape[:-1], dev)
    two = FQ.add(one, one)
    three = FQ.add(two, one)
    a_pd = FQ.to_mont([E2_A], dev)[0]

    def pa(bx, by, bz, ax, ay):
        c = FQ.inv(FQ.sub(bx, ax))
        s1 = FQ.mul(FQ.sub(by, ay), c)
        s2 = FQ.mul(s1, s1)
        omz = FQ.sub(one, bz)
        t1 = FQ.mul(FQ.sub(FQ.sub(s2, ax), bx), omz)
        t2 = FQ.mul(ax, bz)
        cx = FQ.add(t1, t2)
        s3 = FQ.mul(s1, FQ.sub(ax, cx))
        t3 = FQ.mul(FQ.sub(s3, ay), omz)
        t4 = FQ.mul(ay, bz)
        cy = FQ.add(t3, t4)
        return cx, cy, c, s1, s2, s3, t1, t2, t3, t4

    def pd(ax, ay):
        c = FQ.inv(FQ.mul(two, ay))
        t1 = FQ.mul(ax, ax)
        s1 = FQ.mul(FQ.add(FQ.mul(three, t1), a_pd), c)
        s2 = FQ.mul(s1, s1)
        dx = FQ.sub(s2, FQ.mul(two, ax))
        t2 = FQ.mul(s1, FQ.sub(ax, dx))
        dy = FQ.sub(t2, ay)
        return dx, dy, t1, t2, s1, s2, c

    state = (px, py, FQ.zeros(px.shape[:-1], dev),
             FQ.zeros(px.shape[:-1], dev), one)
    steps = []
    for i in range(bits_f.shape[1]):
        bit = bits_f[:, i]
        ax, ay, bx, by, bz = state
        cx, cy, c_pa, s1_pa, s2_pa, s3_pa, t1_pa, t2_pa, t3_pa, t4_pa = \
            pa(bx, by, bz, ax, ay)
        dx, dy, t1_pd, t2_pd, s1_pd, s2_pd, c_pd = pd(ax, ay)
        omb = FQ.sub(one, bit)
        z1 = FQ.mul(cx, bit)
        z2 = FQ.mul(bx, omb)
        bx_n = FQ.add(z1, z2)
        z3 = FQ.mul(cy, bit)
        z4 = FQ.mul(by, omb)
        by_n = FQ.add(z3, z4)
        bz_n = FQ.mul(bz, omb)
        steps.append((dx, dy, bx_n, by_n, bz_n, cx, cy,
                      c_pa, s1_pa, s2_pa, s3_pa, t1_pa, t2_pa, t3_pa, t4_pa,
                      c_pd, t1_pd, s1_pd, s2_pd, t2_pd, z1, z2, z3, z4))
        state = (dx, dy, bx_n, by_n, bz_n)
    return [torch.stack(o, dim=1) for o in zip(*steps)]


DEVICE_WITNESS_THRESHOLD = 200_000


def point_mult_gadget(weights: List[int], mult_px: List[int],
                      mult_py: List[int], n: int = N_BITS_DEFAULT,
                      device=None):
    """Build instance + assignments from a recorded mult trace; the witness
    scan runs on ``device``.

    Returns (inst, vars_para, vars_input, vars_full, inputs, num_cons,
    num_vars, num_inputs, nnz).  Above DEVICE_WITNESS_THRESHOLD variables
    the assignments stay Montgomery tensors."""
    N = len(weights)
    dev = resolve_device(device)
    with span("build_matrices"):
        A, B, C, num_cons, num_vars, num_inputs = build_matrices(N, n)
    with span("R1CSInstance"):
        inst = R1CSInstance(num_cons, num_vars, num_inputs, A, B, C,
                            device=dev)
    on_device = num_vars > DEVICE_WITNESS_THRESHOLD

    for w in weights:
        if not 0 <= int(w) < (1 << n):
            raise ValueError("scalar exceeds gadget bit width")

    with span("witness_scan"):
        bits = np.array([[(int(w) >> k) & 1 for k in range(n)]
                         for w in weights], dtype=object).reshape(N, n)
        bits_f = FQ.to_mont(bits, dev)
        px = FQ.to_mont(mult_px, dev)
        py = FQ.to_mont(mult_py, dev)
        (dx, dy, bx_n, by_n, bz_n, cx, cy,
         c_pa, s1_pa, s2_pa, s3_pa, t1_pa, t2_pa, t3_pa, t4_pa,
         c_pd, t1_pd, s1_pd, s2_pd, t2_pd, z1, z2, z3, z4) = \
            _mult_witness_scan(px, py, bits_f)

    qx = bx_n[:, n - 1]
    qy = by_n[:, n - 1]

    def col(x):            # (N, 8) -> (N, 1, 8)
        return x[:, None, :]

    a_vals = FQ.to_mont([int(w) for w in weights], dev)
    zeros = FQ.zeros((N,), dev)
    onv = 27 * n + 10
    block = torch.cat([
        bits_f,                                   # [0, n)
        col(a_vals),                              # [n]
        col(px), dx,                              # Ax0..Axn
        col(py), dy,                              # Ay0..Ayn
        col(zeros), bx_n,                         # Bx0..Bxn
        col(zeros), by_n,                         # By0..Byn
        col(FQ.ones((N,), dev)), bz_n,            # Bz0..Bzn
        cx, cy, dx, dy,
        col(qx), col(qy), col(px), col(py),
        c_pa, s1_pa, s2_pa, s3_pa, t1_pa, t2_pa, t3_pa, t4_pa,
        c_pd, t1_pd, s1_pd, s2_pd, t2_pd, z1, z2, z3, z4,
    ], dim=1)
    if block.shape[1] != onv:
        raise AssertionError(f"witness block width {block.shape[1]} != {onv}")
    flat = torch.cat([block.reshape(N * onv, 8), FQ.zeros((1,), dev)])
    inputs = [E2_A]

    scalar_slots = torch.as_tensor(n + onv * np.arange(N, dtype=np.int64),
                                   device=dev)
    if on_device:
        vars_full = flat
        vars_para = FQ.zeros((num_vars,), dev)
        vars_para[scalar_slots] = a_vals
        vars_input = flat.clone()
        vars_input[scalar_slots] = zeros
    else:
        vars_full = [int(v) for v in FQ.from_mont(flat)]
        vars_para = [0] * num_vars
        for jj, w in enumerate(weights):
            vars_para[n + onv * jj] = int(w) % L
        vars_input = list(vars_full)
        for jj in range(N):
            vars_input[n + onv * jj] = 0

    with span("is_sat"):
        if not inst.is_sat(vars_full, inputs):
            raise AssertionError("point-mult gadget unsatisfied")
    # SNARKGens sizing uses the actual max nnz (see the reference module's
    # note: it equals the hard-coded bucket estimate after padding at the
    # reference's workload sizes)
    nnz = max(len(A[0]), len(B[0]), len(C[0]))
    return inst, vars_para, vars_input, vars_full, inputs, \
        num_cons, num_vars, num_inputs, nnz
