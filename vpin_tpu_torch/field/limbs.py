"""Limb storage of 256-bit field elements and the exact int64 arithmetic the
plain PyTorch versions compute in.

Storage: 8 little-endian 32-bit limbs in an int32 tensor (..., 8), the bit
pattern of the uint32 limbs the CUDA kernels read.  Montgomery R = 2^256, as
in vpin_tpu, so a residue's value is the same in both packages and vpin_tpu's
16 x 16-bit limbs repack losslessly (vpin_tpu_torch/convert.py).

Working form: CPU PyTorch has no add, sub or >> on uint32, so the plain
versions widen the limbs to int64 values in [0, 2^32) and split them into
16-bit halves where they multiply.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 32
N_LIMBS = 8
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF


# ----------------------------------------------------------------------
# host ints <-> limbs
# ----------------------------------------------------------------------

def ints_to_limbs(ints) -> np.ndarray:
    """Host ints in [0, 2^256) (any nesting) -> (..., 8) uint32 limbs."""
    arr = np.asarray(ints, dtype=object)
    buf = b"".join(int(v).to_bytes(32, "little") for v in arr.reshape(-1))
    return np.frombuffer(buf, dtype="<u4").reshape(arr.shape + (N_LIMBS,)).copy()


def limbs_to_ints(limbs) -> np.ndarray:
    """(..., 8) uint32 limbs -> numpy object array of host ints."""
    arr = np.ascontiguousarray(np.asarray(limbs).astype("<u4", copy=False))
    buf = arr.tobytes()
    n = len(buf) // 32
    out = np.empty((n,), dtype=object)
    out[:] = [int.from_bytes(buf[32 * i:32 * i + 32], "little") for i in range(n)]
    return out.reshape(arr.shape[:-1])


def int_to_limbs(x: int) -> np.ndarray:
    return ints_to_limbs(x)


def limbs_to_int(limbs) -> int:
    return int(limbs_to_ints(np.asarray(limbs).reshape(N_LIMBS)))


def to_tensor(limbs: np.ndarray, device) -> torch.Tensor:
    """(..., 8) uint32 numpy limbs -> int32 tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> (..., 8) uint32 numpy limbs on the host."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ----------------------------------------------------------------------
# int64 working form (plain versions)
# ----------------------------------------------------------------------

def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 limb storage -> int64 limb values in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 limb values in [0, 2^32) -> int32 limb storage (same bits)."""
    return (t - ((t >> 31) << 32)).to(torch.int32)


def carry(x: torch.Tensor):
    """Resolve non-negative int64 limbs (entries < 2^62) into 32-bit limbs.
    Returns (limbs mod 2^256, carry out of the top limb)."""
    cols = x.unbind(-1)
    out = []
    c = 0
    for j in range(N_LIMBS):
        v = cols[j] + c
        out.append(v & MASK32)
        c = v >> LIMB_BITS
    return torch.stack(out, -1), c


def sub_borrow(x: torch.Tensor, y: torch.Tensor):
    """x - y over 32-bit limbs.  Returns (difference mod 2^256, borrow out
    in {0, 1})."""
    cols = (x - y).unbind(-1)
    out = []
    b = 0
    for j in range(N_LIMBS):
        v = cols[j] - b
        out.append(v & MASK32)
        b = -(v >> LIMB_BITS)             # v in [-2^32, 2^32): 1 iff negative
    return torch.stack(out, -1), b


def reduce_once(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x in [0, 2N) -> x mod N."""
    d, b = sub_borrow(x, n)
    return torch.where((b == 1).unsqueeze(-1), x, d)


def add_mod(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(a + b) mod N for canonical limbs; N < 2^255, so a + b < 2^256."""
    s, _ = carry(a + b)
    return reduce_once(s, n)


def sub_mod(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(a - b) mod N for canonical limbs."""
    d, borrow = sub_borrow(a, b)
    s, _ = carry(d + n * borrow.unsqueeze(-1))
    return s


def halves(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) 32-bit limbs -> (..., 16) 16-bit limbs."""
    return torch.stack((x & MASK16, x >> 16), -1).flatten(-2)
