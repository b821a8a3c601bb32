"""K4: batched ristretto255 (extended twisted-Edwards) addition over F_p.

Port of vpin_tpu/curve/pallas_edwards.py (``ed_add_pallas``).  The CUDA
kernel is csrc/ed_add.cu; ``ed_add_plain`` is the same function in plain
PyTorch, the kernel's yardstick on the card and what CPU tensors run.

Points travel as (x, y, z, t) tuples of int32 limb tensors (..., 8) in
Montgomery form, with the identity (0 : 1 : 1 : 0).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.cuda_mont import mont_mul64
from ..field.limbs import N_LIMBS, add_mod, narrow, sub_mod, widen


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
    """The K4 kernel's function in plain PyTorch: add-2008-hwcd-3 (a = -1)
    as in vpin_tpu's RistrettoGroup._add_jnp, on int64 working limbs, with
    its field operations stacked by dependency stage."""
    dev = P[0].device
    k = group.F.consts(dev)
    n = k.n32
    shape = torch.broadcast_shapes(P[0].shape, Q[0].shape)
    X1, Y1, Z1, T1 = (widen(t).expand(shape) for t in P)
    X2, Y2, Z2, T2 = (widen(t).expand(shape) for t in Q)
    d2 = group.device_d2(dev).expand(shape)

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
    return tuple(narrow(t) for t in (X3, Y3, Z3, T3))
