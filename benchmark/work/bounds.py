"""Each kernel launch's bound: the least time the card needs for the work
the call asks for, from the shapes the call is given (chip_smoke.py's
arithmetic, frozen here).

``LaunchLog`` wraps the port's kernel entries while a traced window runs and
keeps, for each call on the card, what the bound needs.  Where a count
depends on the data (a ladder's set bits), it keeps the bits and counts
them once the window has closed, so that the window sees no extra work.
Where the bytes depend on which table entries the digits select (ed_msm),
only the bytes every call must move are counted, so a share is never
counted too high.

``KERNELS`` maps each CUDA kernel of the port (csrc/*.cu) to its entry, so
that the profiler's kernel times can be paired with the bounds.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from .peaks import (MUL32_PER_PRODUCT_L, MUL32_PER_PRODUCT_P, P_25519,
                    PRODUCTS_E2_ADD, PRODUCTS_ED_ADD, bound_s)

#: products mod l an element of a sumcheck round's half: a product at each
#: of the kind's points (quad: A B at t = 0, 2), two a point for the cubic
#: kinds (A B C or A (B C - D) at t = 0, 2, 3)
SC_PRODUCTS = {"quad": 2, "cubic": 6, "cubic_additive": 6}

#: __global__ kernel name -> the entry whose bound it is paired with
KERNELS = {
    "mont_mul_kernel": "mont_mul",
    "mont_pow_kernel": "mont_pow",
    "e2_add_kernel": "e2_add",
    "e2_add_group_kernel": "e2_add",
    "e2_scalar_mul_kernel": "e2_scalar_mul",
    "ed_add_kernel": "ed_add",
    "ed_table_kernel": "ed_table",
    "ed_msm_windows_kernel": "ed_msm",
    "ed_msm_horner_kernel": "ed_msm",
    "ed_ladder_thread_kernel": "ed_ladder",
    "ed_ladder_kernel": "ed_ladder",
    "sc_round_kernel": "sc_round",
    "sc_round_reduce_kernel": "sc_round",
    "sc_bind_kernel": "sc_bind",
}
_KERNEL_RE = re.compile(r"\b(" + "|".join(sorted(KERNELS, key=len,
                                                  reverse=True)) + r")\b")


def kernel_entry(name: str) -> Optional[str]:
    """The port's entry that a profiler kernel name belongs to, or None for
    a kernel that is not the port's (PyTorch's own, a copy)."""
    m = _KERNEL_RE.search(name)
    return KERNELS[m.group(1)] if m else None


def _per_product(field) -> int:
    return (MUL32_PER_PRODUCT_P if int(field.modulus) == P_25519
            else MUL32_PER_PRODUCT_L)


def _n(t) -> int:
    return t.numel() // 8


def sc_bytes(tensors) -> int:
    """Bytes of the distinct elements of limb tensors, each read once (an
    axis broadcast with stride 0 holds one element)."""
    total = 0
    for t in tensors:
        n = 1
        for d, st in zip(t.shape[:-1], t.stride()[:-1]):
            if st != 0:
                n *= int(d)
        total += 32 * n
    return total


def _ladder_adds(words, n: int, n_bits: int, inner: int, nrows: int) -> int:
    """One complete addition per set bit and one doubling per bit but the
    last, for ladder i on bit row (i // inner) % nrows."""
    import torch
    w = words.reshape(nrows, -1).to(torch.int64) & 0xFFFFFFFF
    bits = ((w[:, :, None] >> torch.arange(32, device=w.device)) & 1)
    per_row = bits.reshape(nrows, -1)[:, :n_bits].sum(dim=1).cpu()
    pick = (torch.arange(n) // inner) % nrows
    return int(per_row[pick].sum()) + n * max(n_bits - 1, 0)


class LaunchLog:
    """While entered, records every call of the port's kernel entries made
    on the card: (entry, mul32, bytes) or, for ladders, the bits to count
    later.  ``bounds()`` gives the summed bound seconds by entry."""

    TARGETS = {
        "field.prime_field": ("mont_mul", "mont_pow"),
        "curve.cuda_ec": ("e2_add", "e2_scalar_mul"),
        "curve.cuda_edwards": ("ed_add", "ed_table", "ed_msm", "ed_ladder"),
        "sumcheck.sumcheck": ("sc_round", "sc_bind"),
    }

    def __init__(self):
        self.calls: List[tuple] = []
        self.active = False

    def _record(self, name: str, args):
        a = args
        if name == "mont_mul":
            n = max(_n(a[0]), _n(a[1]))
            self.calls.append((name, _per_product(a[2]) * n, 96 * n))
        elif name == "mont_pow":
            bits = [int(b) for b in a[1]]
            n = _n(a[0])
            self.calls.append((name, _per_product(a[2]) * n
                               * (len(bits) + sum(bits)), 64 * n))
        elif name == "e2_add":
            import torch
            shape = torch.broadcast_shapes(a[1][0].shape, a[2][0].shape)
            n = 1
            for d in shape[:-1]:
                n *= int(d)
            self.calls.append((name, PRODUCTS_E2_ADD * MUL32_PER_PRODUCT_L
                               * n, 288 * n))
        elif name in ("e2_scalar_mul", "ed_ladder"):
            _, P, words, n_bits, inner, nrows = a[:6]
            n = int(P[0].shape[0])
            self.calls.append((name, ("ladder", words, n, int(n_bits),
                                      int(inner), int(nrows))))
        elif name == "ed_add":
            n = max(_n(a[1][0]), _n(a[2][0]))
            self.calls.append((name, PRODUCTS_ED_ADD * MUL32_PER_PRODUCT_P
                               * n, 384 * n))
        elif name == "ed_table":
            m = int(a[1][0].shape[0])
            self.calls.append((name, 255 * m * PRODUCTS_ED_ADD
                               * MUL32_PER_PRODUCT_P, 128 * m + 256 * 128 * m))
        elif name == "ed_msm":
            rows, n = int(a[2].shape[0]), int(a[2].shape[1])
            adds = rows * (32 * max(n - 1, 0) + 288)
            self.calls.append((name, adds * PRODUCTS_ED_ADD
                               * MUL32_PER_PRODUCT_P,
                               rows * n * 32 + rows * 128))
        elif name == "sc_round":
            import torch
            kind, los, his = a[:3]
            lead = torch.broadcast_shapes(*(t.shape[:-2]
                                            for t in (*los, *his)))
            n = int(los[0].shape[-2])
            for d in lead:
                n *= int(d)
            self.calls.append((name, SC_PRODUCTS[kind] * MUL32_PER_PRODUCT_L
                               * n, sc_bytes([*los, *his])))
        elif name == "sc_bind":
            los, his = a[:2]
            n = len(los)
            for d in los[0].shape[:-1]:
                n *= int(d)
            self.calls.append((name, MUL32_PER_PRODUCT_L * n,
                               sc_bytes([*los, *his]) + 32 * n))

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            if self.active and _on_card(args):
                self._record(name, args)
            return fn(*args, **kwargs)
        return wrapper

    def install(self):
        """Wrap the entries (for the whole run; records only while
        ``active``)."""
        import importlib
        self.saved = []
        for mod, names in self.TARGETS.items():
            m = importlib.import_module("vpin_tpu_torch." + mod)
            for name in names:
                fn = getattr(m, name)
                self.saved.append((m, name, fn))
                setattr(m, name, self._wrap(name, fn))
        return self

    def uninstall(self):
        for m, name, fn in self.saved:
            setattr(m, name, fn)

    def bounds(self) -> Dict[str, float]:
        """Summed bound seconds by entry over the recorded calls."""
        out: Dict[str, float] = {}
        for name, *rest in self.calls:
            if isinstance(rest[0], tuple):
                _, words, n, n_bits, inner, nrows = rest[0]
                adds = _ladder_adds(words, n, n_bits, inner, nrows)
                per = (PRODUCTS_E2_ADD * MUL32_PER_PRODUCT_L
                       if name == "e2_scalar_mul"
                       else PRODUCTS_ED_ADD * MUL32_PER_PRODUCT_P)
                b = bound_s(per * adds, 192 * n + words.numel() * 4)
            else:
                b = bound_s(rest[0], rest[1])
            out[name] = out.get(name, 0.0) + b
        self.calls = []
        return out


def _on_card(args) -> bool:
    for a in args:
        t = a[0] if isinstance(a, (tuple, list)) and a else a
        if hasattr(t, "device"):
            return t.device.type == "cuda"
    return False
