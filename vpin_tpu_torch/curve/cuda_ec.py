"""K2 and K3: complete addition and the whole double-and-add ladder on E2.

Port of vpin_tpu/curve/pallas_ec.py (``ec_add_pallas`` and
``ec_ladder_step_pallas``).  The CUDA kernels are csrc/e2_add.cu and
csrc/e2_scalar_mul.cu; ``e2_add_plain`` and ``e2_scalar_mul_plain`` are the
same functions in plain PyTorch, the kernels' yardsticks on the card and what
CPU tensors run.

Points travel as (x, y, z) tuples of int32 limb tensors (..., 8) in
Montgomery form, with infinity = (0 : 1 : 0).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.cuda_mont import mont_mul64
from ..field.limbs import N_LIMBS, add_mod, narrow, sub_mod, widen


# ----------------------------------------------------------------------
# K2: complete addition
# ----------------------------------------------------------------------

def e2_add(curve, P, Q):
    """P + Q over broadcastable batches of points."""
    dev = kernels.check_limbs("e2_add", *P, *Q)
    if dev.type == "cpu":
        return e2_add_plain(curve, P, Q)
    shape = torch.broadcast_shapes(P[0].shape, Q[0].shape)
    ins = [kernels.kernel_operand(t, shape) for t in (*P, *Q)]
    outs = [torch.empty(shape, dtype=torch.int32, device=dev) for _ in range(3)]
    n = outs[0].numel() // N_LIMBS
    if n:
        kernels.launch("e2_add", dev, *(t.data_ptr() for t in ins + outs), n,
                       curve.kernel_consts)
    return tuple(outs)


def e2_add_plain(curve, P, Q):
    """The K2 kernel's function in plain PyTorch."""
    k = curve.F.consts(P[0].device)
    a, b3 = curve.device_ab3(P[0].device)
    out = _add64(tuple(widen(t) for t in P), tuple(widen(t) for t in Q), a, b3, k)
    return tuple(narrow(t) for t in out)


def _add64(P, Q, a, b3, k):
    """RCB15 Alg. 1 (general a) on int64 working limbs.  The same formula
    as vpin_tpu's WeierstrassCurve._add_jnp, with its field operations
    stacked by dependency stage so each stage is one batched call."""
    shape = torch.broadcast_shapes(P[0].shape, Q[0].shape)
    X1, Y1, Z1 = (t.expand(shape) for t in P)
    X2, Y2, Z2 = (t.expand(shape) for t in Q)
    n = k.n32

    def add(xs, ys):
        return add_mod(torch.stack(xs), torch.stack(ys), n).unbind(0)

    def sub(xs, ys):
        return sub_mod(torch.stack(xs), torch.stack(ys), n).unbind(0)

    def mul(xs, ys):
        xs = [x.expand(shape) for x in xs]
        ys = [y.expand(shape) for y in ys]
        return mont_mul64(torch.stack(xs), torch.stack(ys), k).unbind(0)

    sx1y1, sx2y2, sx1z1, sx2z2, sy1z1, sy2z2 = add(
        [X1, X2, X1, X2, Y1, Y2], [Y1, Y2, Z1, Z2, Z1, Z2])
    t0, t1, t2, sxy, sxz, syz = mul([X1, Y1, Z1, sx1y1, sx1z1, sy1z1],
                                    [X2, Y2, Z2, sx2y2, sx2z2, sy2z2])
    t3, t4, t5 = sub([sxy, sxz, syz], add([t0, t0, t1], [t1, t2, t2]))
    at4, b3t2, at2, b3t4 = mul([a, b3, a, b3], [t4, t2, t2, t4])
    (W,) = add([b3t2], [at4])
    (U,) = sub([t1], [W])
    V, M2 = add([t1, t0], [W, t0])
    (M3,) = add([M2], [t0])
    (M,) = add([M3], [at2])                      # 3 X1X2 + a Z1Z2
    (t0mat2,) = sub([t0], [at2])
    y3a, at0mat2 = mul([U, a], [V, t0mat2])
    (S,) = add([b3t4], [at0mat2])
    MS, t5S, Ut3, t3M, t5V = mul([M, t5, U, t3, t5], [S, S, t3, M, V])
    (X3,) = sub([Ut3], [t5S])
    Y3, Z3 = add([y3a, t5V], [MS, t3M])
    return X3, Y3, Z3


# ----------------------------------------------------------------------
# K3: double-and-add ladder
# ----------------------------------------------------------------------

def e2_scalar_mul(curve, P, words, n_bits: int, inner: int, nrows: int):
    """[k_i] P_i for a flat batch of n points (each coordinate (n, 8)).
    ``words`` (nrows, W) int32 holds each scalar's bits LSB-first in 32-bit
    words; point i takes row (i // inner) % nrows."""
    dev = kernels.check_limbs("e2_scalar_mul", *P)
    n = P[0].shape[0]
    _check_bits("e2_scalar_mul", words, n_bits, nrows, inner, dev)
    if P[0].dim() != 2 or any(t.shape != P[0].shape for t in P):
        raise ValueError("e2_scalar_mul: points must be flat (n, 8) batches")
    if dev.type == "cpu":
        return e2_scalar_mul_plain(curve, P, words, n_bits, inner, nrows)
    ins = [kernels.kernel_operand(t, t.shape) for t in P]
    words = words.contiguous()
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        kernels.launch("e2_scalar_mul", dev,
                       *(t.data_ptr() for t in ins), words.data_ptr(),
                       *(t.data_ptr() for t in outs), n, n_bits,
                       words.shape[1], inner, nrows, curve.kernel_consts)
    return tuple(outs)


def _check_bits(name, words, n_bits, nrows, inner, dev):
    """Validate a ladder kernel's packed bit words (K3 and K5)."""
    if words.dtype != torch.int32 or words.device != dev or words.dim() != 2:
        raise ValueError(f"{name}: bit words must be an int32 (rows, words) "
                         "tensor on the points' device")
    if words.shape[0] != nrows or words.shape[1] * 32 < n_bits or nrows < 1 \
            or inner < 1 or n_bits < 0:
        raise ValueError(f"{name}: {tuple(words.shape)} words do not hold "
                         f"{nrows} rows of {n_bits} bits")


def e2_scalar_mul_plain(curve, P, words, n_bits: int, inner: int, nrows: int):
    """The K3 kernel's function in plain PyTorch: the reference's scan of
    ladder steps acc' = bit ? acc + base : acc, base' = base + base, with
    acc = (0 : R : 0) at the start.  A step whose bits are all clear skips
    the addition and the last step skips the doubling; neither changes acc."""
    dev = P[0].device
    n = P[0].shape[0]
    k = curve.F.consts(dev)
    a, b3 = curve.device_ab3(dev)
    rows = (torch.arange(n, device=dev) // inner) % nrows
    w = widen(words)[rows]                                    # (n, W)
    base = tuple(widen(t) for t in P)
    one = widen(curve.F.ones((n,), dev))
    acc = (torch.zeros_like(one), one, torch.zeros_like(one))
    for i in range(n_bits):
        bit = ((w[:, i // 32] >> (i % 32)) & 1).bool().unsqueeze(-1)
        last = i + 1 == n_bits
        if not bool(bit.any()):
            if not last:
                base = _add64(base, base, a, b3, k)
            continue
        if last:
            added = _add64(acc, base, a, b3, k)
        else:
            both = _add64(tuple(torch.cat(p) for p in zip(acc, base)),
                          tuple(torch.cat(p) for p in zip(base, base)),
                          a, b3, k)
            added = tuple(t[:n] for t in both)
            base = tuple(t[n:] for t in both)
        acc = tuple(torch.where(bit, s, c) for s, c in zip(added, acc))
    return tuple(narrow(t) for t in acc)
