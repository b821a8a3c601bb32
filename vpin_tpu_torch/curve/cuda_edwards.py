"""K4 and K5: batched ristretto255 (extended twisted-Edwards) addition over
F_p, and the whole double-and-add ladder.

Port of vpin_tpu/curve/pallas_edwards.py (``ed_add_pallas`` and
``ed_ladder_step_pallas``).  The CUDA kernels are csrc/ed_add.cu and
csrc/ed_ladder.cu; ``ed_add_plain`` and ``ed_ladder_plain`` are the same
functions in plain PyTorch, the kernels' yardsticks on the card and what CPU
tensors run.

Points travel as (x, y, z, t) tuples of int32 limb tensors (..., 8) in
Montgomery form, with the identity (0 : 1 : 1 : 0).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.cuda_mont import mont_mul64
from ..field.limbs import N_LIMBS, add_mod, narrow, sub_mod, widen
from .cuda_ec import _check_bits


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
# K5: double-and-add ladder
# ----------------------------------------------------------------------

def ed_ladder(group, P, words, n_bits: int, inner: int, nrows: int):
    """[k_i] P_i for a flat batch of n points (each coordinate (n, 8)).
    ``words`` (nrows, W) int32 holds each scalar's bits LSB-first in 32-bit
    words; point i takes row (i // inner) % nrows."""
    dev = kernels.check_limbs("ed_ladder", *P)
    n = P[0].shape[0]
    _check_bits("ed_ladder", words, n_bits, nrows, inner, dev)
    if P[0].dim() != 2 or any(t.shape != P[0].shape for t in P):
        raise ValueError("ed_ladder: points must be flat (n, 8) batches")
    if dev.type == "cpu":
        return ed_ladder_plain(group, P, words, n_bits, inner, nrows)
    ins = [kernels.kernel_operand(t, t.shape) for t in P]
    words = words.contiguous()
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    if n:
        kernels.launch("ed_ladder", dev,
                       *(t.data_ptr() for t in ins), words.data_ptr(),
                       *(t.data_ptr() for t in outs), n, n_bits,
                       words.shape[1], inner, nrows, group.kernel_consts)
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
