"""K4 and K5: batched ristretto255 (extended twisted-Edwards) addition over
F_p, the MSM digit table and the table MSM built on it, and the whole
double-and-add ladder.

Port of vpin_tpu/curve/pallas_edwards.py (``ed_add_pallas`` and
``ed_ladder_step_pallas``) and of vpin_tpu/curve/msm.py's jitted table build
and table MSM, which scanned that addition.  The CUDA kernels are
csrc/ed_add.cu (entries ``ed_add``, ``ed_table``, ``ed_msm``) and
csrc/ed_ladder.cu; ``ed_add_plain``, ``ed_table_plain``, ``ed_msm_plain`` and
``ed_ladder_plain`` are the same functions in plain PyTorch, the kernels'
yardsticks on the card and what CPU tensors run.

Points travel as (x, y, z, t) tuples of int32 limb tensors (..., 8) in
Montgomery form, with the identity (0 : 1 : 1 : 0).

K5 gives each ladder to a group of lanes of one warp, which runs the stage
schedule of csrc/ed_sched.cuh on K2 and K3's group runner (csrc/e2.cuh,
curve/e2_sched.py); ``ed_ladder_lanes`` says how many for a batch, from the
times measured on the H100 (PERF.md).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.cuda_mont import mont_mul64
from ..field.limbs import N_LIMBS, add_mod, narrow, sub_mod, widen
from . import e2_sched
from .cuda_ec import _check_bits


#: lanes a ladder K5 offers: 1 (one thread a ladder), 4 or 8 (a group)
LADDER_LANES = (1, 4, 8)


def ed_ladder_lanes(n: int) -> int:
    """Lanes a ladder for K5 on n ladders: 8, 4 from 8,192 ladders and 1
    (one thread a ladder) from 16,384, the fastest at each batch measured
    on the H100 (PERF.md): once the card fills, lanes that idle through a
    round cost more than the chain of products."""
    return 8 if n < 8192 else 4 if n < 16384 else 1


# ----------------------------------------------------------------------
# K4: unified addition
# ----------------------------------------------------------------------

def ed_add(group, P, Q):
    """P + Q over broadcastable batches of points: kernel K4 for CUDA
    tensors of any batch size, the plain version for CPU tensors."""
    dev = kernels.check_limbs("ed_add", *P, *Q)
    if dev.type == "cpu":
        return ed_add_plain(group, P, Q)
    shape = torch.broadcast_shapes(P[0].shape, Q[0].shape)
    ins = [kernels.kernel_operand(t, shape) for t in (*P, *Q)]
    outs = [torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(4)]
    n = outs[0].numel() // N_LIMBS
    if n:
        kernels.launch("ed_add", dev, *(t.data_ptr() for t in ins + outs), n,
                       group.kernel_consts)
    return tuple(outs)


def ed_add_plain(group, P, Q):
    """The K4 kernel's function in plain PyTorch."""
    k = group.F.consts(P[0].device)
    out = _add64(tuple(widen(t) for t in P), tuple(widen(t) for t in Q),
                 group.device_d2(P[0].device), k)
    return tuple(narrow(t) for t in out)


def _add64(P, Q, d2, k):
    """add-2008-hwcd-3 (a = -1) on int64 working limbs, as in vpin_tpu's
    RistrettoGroup._add_jnp, with its field operations stacked by dependency
    stage so each stage is one batched call."""
    n = k.n32
    shape = torch.broadcast_shapes(P[0].shape, Q[0].shape)
    X1, Y1, Z1, T1 = (t.expand(shape) for t in P)
    X2, Y2, Z2, T2 = (t.expand(shape) for t in Q)
    d2 = d2.expand(shape)

    def add(xs, ys):
        return add_mod(torch.stack(xs), torch.stack(ys), n).unbind(0)

    def sub(xs, ys):
        return sub_mod(torch.stack(xs), torch.stack(ys), n).unbind(0)

    def mul(xs, ys):
        return mont_mul64(torch.stack(xs), torch.stack(ys), k).unbind(0)

    u1, u2 = sub([Y1, Y2], [X1, X2])
    v1, v2, z2 = add([Y1, Y2, Z2], [X1, X2, Z2])
    A, B, dT2, Dd = mul([u1, v1, d2, Z1], [u2, v2, T2, z2])
    (C,) = mul([T1], [dT2])
    E, F = sub([B, Dd], [A, C])
    G, H = add([Dd, B], [C, A])
    X3, Y3, T3, Z3 = mul([E, G, E, F], [F, H, H, G])
    return X3, Y3, Z3, T3


# ----------------------------------------------------------------------
# K4: MSM digit table and table MSM
# ----------------------------------------------------------------------

#: rows of a digit table: the digits of one 8-bit window
TABLE_ROWS = 256
#: windows of a scalar mod l (32 x 8 bits)
MSM_WINDOWS = 32
#: points a warp of the MSM's first launch sums, 32 per lane: csrc/ed_add.cu's
#: MSM_CHUNK
MSM_CHUNK = 1024
#: bound on the points the plain MSM gathers at once
_PLAIN_GATHER = 1 << 21


def _flat_points(name, P):
    dev = kernels.check_limbs(name, *P)
    if P[0].dim() != 2 or any(t.shape != P[0].shape for t in P):
        raise ValueError(f"{name}: points must be flat (n, 8) batches")
    return dev


def ed_table(group, P):
    """Digit table of a flat base batch P (n,): (256, n) points with
    table[d, i] = d * P_i, row d the sum of row d - 1 and P.  One launch on
    CUDA tensors; the plain version on CPU tensors."""
    dev = _flat_points("ed_table", P)
    if dev.type == "cpu":
        return ed_table_plain(group, P)
    ins = [kernels.kernel_operand(t, t.shape) for t in P]
    n = ins[0].shape[0]
    outs = [torch.empty((TABLE_ROWS, n, N_LIMBS), dtype=torch.int32,
                        device=dev) for _ in range(4)]
    if n:
        kernels.launch("ed_table", dev, *(t.data_ptr() for t in ins + outs),
                       n, group.kernel_consts)
    return tuple(outs)


def ed_table_plain(group, P):
    """The ed_table kernel's function in plain PyTorch: 255 additions in a
    chain, row d = row d-1 + P, from the identity."""
    dev = P[0].device
    n = P[0].shape[0]
    k = group.F.consts(dev)
    d2 = group.device_d2(dev)
    base = tuple(widen(t) for t in P)
    one = widen(group.F.ones((n,), dev))
    zero = torch.zeros_like(one)
    rows = [(zero, one, one, zero)]
    for _ in range(TABLE_ROWS - 1):
        rows.append(_add64(rows[-1], base, d2, k))
    return tuple(narrow(torch.stack([r[c] for r in rows])) for c in range(4))


def ed_msm(group, table, digits):
    """sum_i table[digits[r, i, w], i] * 2^(8w) over i < n and w < 32 for
    every row r: ``table`` (256, width) points, ``digits`` (rows, n, 32)
    uint8 with n <= width.  Returns (rows,) points.  Two launches on CUDA
    tensors (window sums by chunks of MSM_CHUNK points, then the partials'
    fold and Horner); the plain version on CPU tensors."""
    dev = kernels.check_limbs("ed_msm", *table)
    rows, n, width = _check_msm("ed_msm", table, digits, dev)
    if dev.type == "cpu":
        return ed_msm_plain(group, table, digits)
    tab = [kernels.kernel_operand(t, t.shape) for t in table]
    digits = digits.contiguous()
    nchunks = -(-n // MSM_CHUNK)
    part = [torch.empty((rows * MSM_WINDOWS * nchunks, N_LIMBS),
                        dtype=torch.int32, device=dev) for _ in range(4)]
    outs = [torch.empty((rows, N_LIMBS), dtype=torch.int32, device=dev)
            for _ in range(4)]
    if rows:
        kernels.launch("ed_msm", dev, *(t.data_ptr() for t in tab), width,
                       digits.data_ptr(), rows, n,
                       *(t.data_ptr() for t in part + outs),
                       group.kernel_consts, count=2 if n else 1)
    return tuple(outs)


def _check_msm(name, table, digits, dev):
    if table[0].dim() != 3 or table[0].shape[0] != TABLE_ROWS or any(
            t.shape != table[0].shape for t in table):
        raise ValueError(f"{name}: the table must be (256, width, 8) points")
    if digits.dtype != torch.uint8 or digits.dim() != 3 \
            or digits.shape[2] != MSM_WINDOWS or digits.device != dev:
        raise ValueError(f"{name}: digits must be uint8 (rows, n, 32) on "
                         f"{dev}, got {digits.dtype} {tuple(digits.shape)} "
                         f"on {digits.device}")
    rows, n, _ = digits.shape
    width = table[0].shape[1]
    if n > width:
        raise ValueError(f"{name}: {n} digit columns for a table {width} "
                         "wide")
    return rows, n, width


def ed_msm_plain(group, table, digits, chunk: int = MSM_CHUNK):
    """The ed_msm kernels' function in plain PyTorch, in their association:
    chunk c of every (row, window) covers points [c * chunk, (c + 1) * chunk)
    of the n; lane j of 32 sums its points j, j + 32, ... in order, the lanes
    fold by a halving tree (lane j takes lane j + h, h = 16 .. 1, where that
    lane holds a sum), the chunks' partials fold in order, and Horner runs
    MSB first: 8 self-additions, then + Q_w.  ``chunk`` other than the
    kernel's (a positive multiple of 32) gives the same sum in another
    association, which the CPU tests use to reach several chunks and lanes
    at small n."""
    dev = table[0].device
    rows, n, _ = _check_msm("ed_msm_plain", table, digits, dev)
    k = group.F.consts(dev)
    d2 = group.device_d2(dev)
    one = widen(group.F.ones((rows,), dev))
    zero = torch.zeros_like(one)
    identity = (zero, one, one, zero)
    nchunks = -(-n // chunk)
    if nchunks:
        # point index of (chunk c, step s, lane j); steps past every
        # chunk's last point are never taken
        steps = -(-min(n, chunk) // 32)
        c = torch.arange(nchunks, device=dev).view(-1, 1, 1)
        s = torch.arange(steps, device=dev).view(1, -1, 1)
        j = torch.arange(32, device=dev).view(1, 1, -1)
        idx = c * chunk + s * 32 + j                       # (C, S, 32)
        valid = (s * 32 + j < chunk) & (idx < n)
        idx = torch.where(valid, idx, torch.zeros_like(idx))
        lanes = valid[:, 0]                                 # (C, 32)
        group_w = max(1, min(MSM_WINDOWS,
                             _PLAIN_GATHER // max(1, rows * idx.numel())))
        parts = []
        for w0 in range(0, MSM_WINDOWS, group_w):
            dig = digits[:, :, w0:w0 + group_w].long()      # (rows, n, G)
            dig = dig.permute(0, 2, 1)[:, :, idx]           # (rows, G, C, S, 32)
            pts = tuple(widen(t[dig, idx]) for t in table)
            acc = tuple(p[:, :, :, 0] for p in pts)         # (rows, G, C, 32, 8)
            for step in range(1, steps):
                new = _add64(acc, tuple(p[:, :, :, step] for p in pts), d2, k)
                take = valid[:, step].unsqueeze(-1)
                acc = tuple(torch.where(take, x, a) for x, a in zip(new, acc))
            h = 16
            while h:
                src = lanes[:, h:2 * h].unsqueeze(-1)
                if bool(src.any()):
                    lo = tuple(a[..., :h, :] for a in acc)
                    new = _add64(lo, tuple(a[..., h:2 * h, :] for a in acc),
                                 d2, k)
                    acc = tuple(torch.where(src, x, a) for x, a in zip(new, lo))
                else:
                    acc = tuple(a[..., :h, :] for a in acc)
                h //= 2
            parts.append(tuple(a[..., 0, :] for a in acc))  # (rows, G, C, 8)
        part = tuple(torch.cat([p[i] for p in parts], 1) for i in range(4))
        Q = tuple(p[:, :, 0] for p in part)                 # (rows, 32, 8)
        for c in range(1, nchunks):
            Q = _add64(Q, tuple(p[:, :, c] for p in part), d2, k)
        Qw = [tuple(q[:, w] for q in Q) for w in range(MSM_WINDOWS)]
    else:
        Qw = [identity] * MSM_WINDOWS
    acc = identity
    for q in reversed(Qw):
        for _ in range(8):
            acc = _add64(acc, acc, d2, k)
        acc = _add64(acc, q, d2, k)
    return tuple(narrow(t) for t in acc)


# ----------------------------------------------------------------------
# K5: double-and-add ladder
# ----------------------------------------------------------------------

def ed_ladder(group, P, words, n_bits: int, inner: int, nrows: int,
              _lanes=None):
    """[k_i] P_i for a flat batch of n points (each coordinate (n, 8)).
    ``words`` (nrows, W) int32 holds each scalar's bits LSB-first in 32-bit
    words; point i takes row (i // inner) % nrows.  ``_lanes``, a hook for
    measuring the choice ``ed_ladder_lanes`` makes: the kernel's lanes a
    ladder, one of LADDER_LANES."""
    dev = _flat_points("ed_ladder", P)
    n = P[0].shape[0]
    _check_bits("ed_ladder", words, n_bits, nrows, inner, dev)
    lanes = ed_ladder_lanes(n) if _lanes is None else _lanes
    if lanes not in LADDER_LANES:
        raise ValueError(f"ed_ladder: no kernel for {lanes} lanes a ladder")
    if dev.type == "cpu":
        return ed_ladder_plain(group, P, words, n_bits, inner, nrows)
    ins = [kernels.kernel_operand(t, t.shape) for t in P]
    words = words.contiguous()
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    prog = e2_sched.program("ed_ladder", lanes, dev).data_ptr() \
        if lanes > 1 else None
    if n:
        kernels.launch("ed_ladder", dev,
                       *(t.data_ptr() for t in ins), words.data_ptr(),
                       *(t.data_ptr() for t in outs), n, n_bits,
                       words.shape[1], inner, nrows, group.kernel_consts,
                       lanes, prog)
    return tuple(outs)


def ed_ladder_plain(group, P, words, n_bits: int, inner: int, nrows: int):
    """The K5 kernel's function in plain PyTorch: the reference's scan of
    ladder steps acc' = bit ? acc + base : acc, base' = base + base, with
    acc = (0 : R : R : 0) at the start.  A step whose bits are all clear
    skips the addition and the last step skips the doubling; neither changes
    acc."""
    dev = P[0].device
    n = P[0].shape[0]
    k = group.F.consts(dev)
    d2 = group.device_d2(dev)
    rows = (torch.arange(n, device=dev) // inner) % nrows
    w = widen(words)[rows]                                    # (n, W)
    base = tuple(widen(t) for t in P)
    one = widen(group.F.ones((n,), dev))
    zero = torch.zeros_like(one)
    acc = (zero, one, one, zero)
    for i in range(n_bits):
        bit = ((w[:, i // 32] >> (i % 32)) & 1).bool().unsqueeze(-1)
        last = i + 1 == n_bits
        if not bool(bit.any()):
            if not last:
                base = _add64(base, base, d2, k)
            continue
        if last:
            added = _add64(acc, base, d2, k)
        else:
            both = _add64(tuple(torch.cat(p) for p in zip(acc, base)),
                          tuple(torch.cat(p) for p in zip(base, base)), d2, k)
            added = tuple(t[:n] for t in both)
            base = tuple(t[n:] for t in both)
        acc = tuple(torch.where(bit, s, c) for s, c in zip(added, acc))
    return tuple(narrow(t) for t in acc)
