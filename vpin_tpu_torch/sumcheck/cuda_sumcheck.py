"""The sumchecks' round sums and binds as CUDA kernels: csrc/sumcheck.cu,
entries ``sc_round`` and ``sc_bind``.

Replaces no TPU kernel (vpin_tpu runs these rounds as jnp code).  The plain
versions are sumcheck.round_sums_split's and bind_tables' torch code, which
CPU tensors take; on CUDA tensors those functions call ``sc_round`` and
``sc_bind`` here, which launch the kernels or raise.  A round is one launch,
or two where its half is long enough for several blocks an instance
(``round_blocks``); a bind is one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from .. import kernels
from ..field import FQ
from ..field.limbs import N_LIMBS

#: kind -> (its code in csrc/sumcheck.cu, tables, points)
KINDS = {"quad": (0, 2, 2), "cubic": (1, 3, 3), "cubic_additive": (2, 4, 3)}

#: SC_THREADS and SC_BIND_THREADS of csrc/sumcheck.cu
THREADS = 256
#: half-table elements a thread of sc_round takes at least, before an
#: instance gets another block
ELEMS = 2
#: sc_round's blocks over all instances at most (eight an SM of the H100)
MAX_BLOCKS = 1024
#: sc_bind's blocks a table at most (the rest of the elements grid-stride)
MAX_BIND_BLOCKS = 2048
#: tables one sc_bind launch binds at most (SC_MAX_TABLES)
MAX_TABLES = 4


def round_blocks(K: int, h: int) -> int:
    """sc_round's blocks an instance for K instances of half length h: one
    for each THREADS x ELEMS elements, at most MAX_BLOCKS over all, at
    least one.  Above one, a second launch sums the blocks' partial sums."""
    want = -(-h // (THREADS * ELEMS))
    return max(1, min(want, MAX_BLOCKS // max(K, 1)))


def _require_cuda(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")


def _instances(name: str, t: torch.Tensor, lead) -> torch.Tensor:
    """t (..., h, 8) broadcast to lead + (h, 8), as a (K, h, 8) view the
    kernel reads through its strides (16-byte aligned elements)."""
    if t.dim() < 2:
        raise ValueError(f"{name}: tables must be (..., h, 8), got shape "
                         f"{tuple(t.shape)}")
    t = t.expand(tuple(lead) + tuple(t.shape[-2:]))
    t = t.reshape((-1,) + tuple(t.shape[-2:])) if lead else t.unsqueeze(0)
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
            s % 4 for s, n in zip(t.stride()[:2], t.shape[:2]) if n > 1):
        raise ValueError(f"{name}: the limb axis must be contiguous and each "
                         f"element 16-byte aligned (strides {t.stride()})")
    return t


def _stride(t: torch.Tensor, d: int) -> int:
    return t.stride(d) if t.shape[d] > 1 else 0


def _desc(los, his) -> ctypes.Array:
    """The tables' halves as csrc/sumcheck.cu's read_tables takes them."""
    words = []
    for lo, hi in zip(los, his):
        words += [lo.data_ptr(), hi.data_ptr(), _stride(lo, 0), _stride(lo, 1),
                  _stride(hi, 0), _stride(hi, 1)]
    return (ctypes.c_longlong * len(words))(*words)


def sc_round(kind: str, los: Sequence[torch.Tensor],
             his: Sequence[torch.Tensor],
             acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """round_sums_split on CUDA tensors: the kind's sums over the halves
    los, his (..., h, 8) at its points, as Montgomery limbs (points, ...,
    8), plus ``acc`` (the same shape) when given.  The leading axes
    broadcast; a table broadcast along them is read through its stride."""
    if kind not in KINDS:
        raise ValueError(f"unknown round kind {kind!r}")
    code, ntab, npts = KINDS[kind]
    if len(los) != ntab or len(his) != ntab:
        raise ValueError(f"sc_round: {kind} takes {ntab} tables, got "
                         f"{len(los)} and {len(his)} halves")
    dev = kernels.check_limbs("sc_round", *los, *his,
                              *([acc] if acc is not None else []))
    halves = {t.shape[-2] if t.dim() >= 2 else -1 for t in (*los, *his)}
    if len(halves) != 1 or -1 in halves:
        raise ValueError(f"sc_round: halves of different lengths or shapes: "
                         f"{[tuple(t.shape) for t in (*los, *his)]}")
    h = halves.pop()
    lead = torch.broadcast_shapes(*(t.shape[:-2] for t in (*los, *his)))
    shape = (npts,) + tuple(lead) + (N_LIMBS,)
    if acc is not None and tuple(acc.shape) != shape:
        raise ValueError(f"sc_round: acc of shape {tuple(acc.shape)}, the "
                         f"sums' is {shape}")
    _require_cuda("sc_round", dev)
    K = math.prod(lead)
    if K == 0 or h == 0:
        return acc.clone() if acc is not None else torch.zeros(
            shape, dtype=torch.int32, device=dev)
    lv = [_instances("sc_round", t, lead) for t in los]
    hv = [_instances("sc_round", t, lead) for t in his]
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    acc = acc.contiguous() if acc is not None else None
    nb = round_blocks(K, h)
    partial = (torch.empty((K * nb * npts, N_LIMBS), dtype=torch.int32,
                           device=dev) if nb > 1 else None)
    kernels.launch("sc_round", dev, _desc(lv, hv), code, K, h,
                   out.data_ptr(), acc.data_ptr() if acc is not None else None,
                   partial.data_ptr() if partial is not None else None, nb,
                   FQ.kernel_consts, count=2 if nb > 1 else 1)
    return out


def sc_bind(los: Sequence[torch.Tensor], his: Sequence[torch.Tensor], r: int,
            out: torch.Tensor) -> torch.Tensor:
    """bind_tables' chunk on CUDA tensors: out[t] = los[t] + r (his[t] -
    los[t]) for up to MAX_TABLES tables whose halves all have one shape
    (..., m, 8), written into ``out`` (T, ..., m, 8), a view of the bound
    tables.  r is a host int; the kernel takes it as r R mod l."""
    T = len(los)
    if not 1 <= T <= MAX_TABLES or len(his) != T:
        raise ValueError(f"sc_bind: 1 to {MAX_TABLES} tables, got {T} and "
                         f"{len(his)} halves")
    dev = kernels.check_limbs("sc_bind", *los, *his, out)
    shape = tuple(los[0].shape)
    if len(shape) < 2 or any(tuple(t.shape) != shape for t in (*los, *his)):
        raise ValueError(f"sc_bind: halves of different shapes: "
                         f"{[tuple(t.shape) for t in (*los, *his)]}")
    if tuple(out.shape) != (T,) + shape:
        raise ValueError(f"sc_bind: out of shape {tuple(out.shape)}, the "
                         f"bound tables' is {(T,) + shape}")
    _require_cuda("sc_bind", dev)
    lead, m = shape[:-2], shape[-2]
    K = math.prod(lead)
    if K == 0 or m == 0:
        return out
    lv = [_instances("sc_bind", t, lead) for t in los]
    hv = [_instances("sc_bind", t, lead) for t in his]
    o = out.view((T, K, m, N_LIMBS))
    if o.stride(-1) != 1 or o.data_ptr() % 16 or any(
            s % 4 for s, n in zip(o.stride()[:3], o.shape[:3]) if n > 1):
        raise ValueError(f"sc_bind: out's limb axis must be contiguous and "
                         f"each element 16-byte aligned (strides "
                         f"{o.stride()})")
    blocks = min(-(-K * m // THREADS), MAX_BIND_BLOCKS)
    r_words = kernels.consts_array(FQ.mont_limbs_np(r))
    kernels.launch("sc_bind", dev, _desc(lv, hv), T, K, m, o.data_ptr(),
                   o.stride(0), o.stride(1), o.stride(2), blocks, r_words,
                   FQ.kernel_consts)
    return out
