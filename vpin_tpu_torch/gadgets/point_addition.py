"""Point-addition R1CS gadget: 10 constraints / 15 variables per EC add.

Port of vpin_tpu/gadgets/point_addition.py, constraint-index-compatible with
the reference circuit (vPIN_proof_generation/src/point_addition.rs:23-326),
so the A/B/C matrices and hence the transcripts are identical:

  c*(Rx-Px)=1; (Ry-Py)*c=s1; s1*s1=s2; (s2-Px-Rx)*(1-Rz)=t1; Px*Rz=t2;
  t1+t2=x3; s1*(Px-x3)=s3; (s3-Py)*(1-Rz)=t3; Py*Rz=t4; t3+t4=y3

Variable block per add i (stride 15):
  [c, Rx, Px, Ry, Py, Rz, s1, s2, s3, t1, t2, t3, t4, x3, y3]

vars_para is all-zero and vars_input is the full witness (reference
:223-267: the adds carry no model parameters).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..field import FQ
from ..field.prime_field import L_MODULUS as L
from ..poly.dense import host_tables_wanted
from ..snark.r1cs import R1CSInstance

MINUS_ONE = L - 1


def nnz_param(n_adds: int) -> int:
    """Hard-coded nnz bucket table (reference point_addition.rs:40-65)."""
    n = n_adds
    if n < 780:
        p = (2, 25, 3)
    elif 2130 < n < 2150:
        p = (5, 30, 5)
    elif 2149 < n < 2450:
        p = (3, 30, 5)
    elif 5000 < n < 8000:
        p = (3, 20, 5)
    else:
        p = (5, 30, 5)
    return p[0] * (p[1] // p[2]) * n


def build_matrices(n_adds: int) -> Tuple[list, list, list, int, int, int]:
    """-> (A, B, C, num_cons, num_vars, num_inputs); entries (row, col, val)."""
    num_vars = 15 * n_adds + 1
    ONE = num_vars  # constant-one column
    i = np.arange(n_adds, dtype=np.int64)
    r = 10 * i
    v = 15 * i

    def mk(rows, cols, vals):
        return np.stack([rows, cols], axis=1), vals

    A, B, C = [], [], []

    def push(mat, row_off, col, val):
        rows = r + row_off
        cols = col if isinstance(col, np.ndarray) else np.full(n_adds, col, np.int64)
        mat.append((rows, cols, np.full(n_adds, val, dtype=object)))

    # constraint 0: c * (Rx - Px) = 1
    push(A, 0, v + 0, 1)
    push(B, 0, v + 1, 1)
    push(B, 0, v + 2, MINUS_ONE)
    push(C, 0, ONE, 1)
    # constraint 1: (Ry - Py) * c = s1
    push(A, 1, v + 3, 1)
    push(A, 1, v + 4, MINUS_ONE)
    push(B, 1, v + 0, 1)
    push(C, 1, v + 6, 1)
    # constraint 2: s1 * s1 = s2
    push(A, 2, v + 6, 1)
    push(B, 2, v + 6, 1)
    push(C, 2, v + 7, 1)
    # constraint 3: (s2 - Px - Rx) * (1 - Rz) = t1
    push(A, 3, v + 7, 1)
    push(A, 3, v + 2, MINUS_ONE)
    push(A, 3, v + 1, MINUS_ONE)
    push(B, 3, ONE, 1)
    push(B, 3, v + 5, MINUS_ONE)
    push(C, 3, v + 9, 1)
    # constraint 4: Px * Rz = t2
    push(A, 4, v + 2, 1)
    push(B, 4, v + 5, 1)
    push(C, 4, v + 10, 1)
    # constraint 5: (t1 + t2) * 1 = x3
    push(A, 5, v + 9, 1)
    push(A, 5, v + 10, 1)
    push(B, 5, ONE, 1)
    push(C, 5, v + 13, 1)
    # constraint 6: s1 * (Px - x3) = s3
    push(A, 6, v + 6, 1)
    push(B, 6, v + 2, 1)
    push(B, 6, v + 13, MINUS_ONE)
    push(C, 6, v + 8, 1)
    # constraint 7: (s3 - Py) * (1 - Rz) = t3
    push(A, 7, v + 8, 1)
    push(A, 7, v + 4, MINUS_ONE)
    push(B, 7, ONE, 1)
    push(B, 7, v + 5, MINUS_ONE)
    push(C, 7, v + 11, 1)
    # constraint 8: Py * Rz = t4
    push(A, 8, v + 4, 1)
    push(B, 8, v + 5, 1)
    push(C, 8, v + 12, 1)
    # constraint 9: (t3 + t4) * 1 = y3
    push(A, 9, v + 11, 1)
    push(A, 9, v + 12, 1)
    push(B, 9, ONE, 1)
    push(C, 9, v + 14, 1)

    def flatten(parts):
        rows = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        vals = np.concatenate([p[2] for p in parts])
        return (rows, cols, vals)          # array triple (SparseMat-native)

    return (flatten(A), flatten(B), flatten(C),
            10 * n_adds, num_vars, 0)


def _pa_witness(px, py, rx, ry, rz):
    """Batched affine-chord witness (reference point_addition.rs:209-220);
    inputs are FQ tensors (n, 8), rz in {0, 1} as field elements."""
    one = FQ.ones(px.shape[:-1], px.device)
    c = FQ.inv(FQ.sub(rx, px))
    s1 = FQ.mul(FQ.sub(ry, py), c)
    s2 = FQ.mul(s1, s1)
    one_m_rz = FQ.sub(one, rz)
    t1 = FQ.mul(FQ.sub(FQ.sub(s2, px), rx), one_m_rz)
    t2 = FQ.mul(px, rz)
    x3 = FQ.add(t1, t2)
    s3 = FQ.mul(s1, FQ.sub(px, x3))
    t3 = FQ.mul(FQ.sub(s3, py), one_m_rz)
    t4 = FQ.mul(py, rz)
    y3 = FQ.add(t3, t4)
    return c, s1, s2, s3, t1, t2, t3, t4, x3, y3


DEVICE_WITNESS_THRESHOLD = 200_000


def point_addition_gadget(add_px: List[int], add_py: List[int],
                          add_rx: List[int], add_ry: List[int],
                          add_rz: List[int], device=None):
    """Build instance + assignments from a recorded add trace.

    Returns (inst, vars_para, vars_input, vars_full, inputs, num_cons,
    num_vars, num_inputs, nnz).  Above DEVICE_WITNESS_THRESHOLD variables
    the three assignments are Montgomery tensors on ``device``, which every
    prove path takes directly; smaller traces stay host ints."""
    n = len(add_px)
    A, B, C, num_cons, num_vars, num_inputs = build_matrices(n)
    inst = R1CSInstance(num_cons, num_vars, num_inputs, A, B, C, device=device)
    on_device = num_vars > DEVICE_WITNESS_THRESHOLD
    nnz = max(len(A[0]), len(B[0]), len(C[0]))

    if not on_device and host_tables_wanted(num_vars):
        # host witness: the affine-chord formulas in Python ints
        vars_full: List[int] = []
        for i in range(n):
            px_, py_ = add_px[i] % L, add_py[i] % L
            rx_, ry_ = add_rx[i] % L, add_ry[i] % L
            rz_ = int(add_rz[i])
            c = pow((rx_ - px_) % L, -1, L)
            s1 = (ry_ - py_) * c % L
            s2 = s1 * s1 % L
            t1 = (s2 - px_ - rx_) * (1 - rz_) % L
            t2 = px_ * rz_ % L
            x3 = (t1 + t2) % L
            s3 = s1 * (px_ - x3) % L
            t3 = (s3 - py_) * (1 - rz_) % L
            t4 = py_ * rz_ % L
            y3 = (t3 + t4) % L
            vars_full += [c, rx_, px_, ry_, py_, rz_, s1, s2, s3,
                          t1, t2, t3, t4, x3, y3]
        vars_full.append(0)
        inputs: List[int] = []
        if not inst.is_sat(vars_full, inputs):
            raise AssertionError("point-add gadget unsatisfied")
        return (inst, [0] * num_vars, list(vars_full), vars_full, inputs,
                num_cons, num_vars, num_inputs, nnz)

    dev = resolve_device(device)
    px = FQ.to_mont(add_px, dev)
    py = FQ.to_mont(add_py, dev)
    rx = FQ.to_mont(add_rx, dev)
    ry = FQ.to_mont(add_ry, dev)
    rz = FQ.to_mont([int(b) for b in add_rz], dev)
    c, s1, s2, s3, t1, t2, t3, t4, x3, y3 = _pa_witness(px, py, rx, ry, rz)

    # interleave into the 15-stride layout: (n, 15, 8) -> flat
    block = torch.stack([c, rx, px, ry, py, rz, s1, s2, s3,
                         t1, t2, t3, t4, x3, y3], dim=1)
    vars_dev = torch.cat([block.reshape(n * 15, 8), FQ.zeros((1,), dev)])
    inputs = []

    if on_device:
        vars_full = vars_dev
        vars_para = FQ.zeros((num_vars,), dev)
        vars_input = vars_dev
    else:
        vars_full = [int(v) for v in FQ.from_mont(vars_dev)]
        vars_para = [0] * num_vars
        vars_input = list(vars_full)

    if not inst.is_sat(vars_full, inputs):
        raise AssertionError("point-add gadget unsatisfied")
    return inst, vars_para, vars_input, vars_full, inputs, \
        num_cons, num_vars, num_inputs, nnz
