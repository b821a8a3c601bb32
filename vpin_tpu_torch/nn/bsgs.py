"""Baby-step/giant-step discrete log, batched on the device.

Port of vpin_tpu/nn/bsgs.py (reference: src/Pre_computed_table/
baby-step-giant-step.py for the table, cnn_networks/Client.py giant_step
for the search).

  * The baby table j*G, j in [1, m), is built on the device by a
    doubling-block construction: chunk t+1 = chunk t + (chunk * G), one K2
    launch and one affine conversion (K1's mont_pow inverse) per chunk.
  * A point's key is a 64-bit mix of the low 64 bits of its canonical affine
    x and y.  The device computes it from limbs 0-1 in int64 bit patterns
    (multiplication wraps mod 2^64, which is what the reference's uint64
    arithmetic does) and keeps the table sorted on the device, so a lookup is
    one torch.searchsorted.  CPU torch has no uint64 arithmetic, so the device
    copy stores each key XOR 2^63: signed order of those is the unsigned
    order of the keys.
  * Giant steps run K strides at a time for the +M and -M chains together:
    each round is one batched add, one affine conversion and one lookup.
    The K strides are built on the device by doubling blocks and kept on
    the table for the next call with the same K.

The pickle cache keeps the reference's format byte for byte ({"m", "keys":
uint64 sorted unsigned, "perm": int64}, ties in the order of a stable
argsort), so each package reads the other's cache.  Every result is checked
at the end with one batched scalar multiplication (K3), so a key collision
cannot produce a wrong plaintext.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..curve.host_ec import E2_G_HOST, E2_ORDER
from ..curve.weierstrass import E2, PointW, cat_points, scalars_to_bits, take
from ..device import resolve_device
from ..field.limbs import int_to_limbs, to_tensor, widen

_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xC2B2AE3D27D4EB4F)
_U64 = (1 << 64) - 1
# the same constants as int64 bit patterns (both are negative)
_MIX1_I64 = int(_MIX1) - (1 << 64)
_MIX2_I64 = int(_MIX2) - (1 << 64)
#: XOR with this maps unsigned 64-bit order onto signed int64 order
_SIGN = -(1 << 63)


def _mix_keys(xs, ys) -> np.ndarray:
    """Vectorized 64-bit key from affine coordinate integers (host ints)."""
    xl = np.asarray([int(v) & _U64 for v in xs], dtype=np.uint64)
    yl = np.asarray([int(v) & _U64 for v in ys], dtype=np.uint64)
    return xl * _MIX1 ^ (yl * _MIX2)


def _low64(plain: torch.Tensor) -> torch.Tensor:
    """The low 64 bits of plain (non-Montgomery) limbs (..., 8) as an int64
    bit pattern."""
    return widen(plain[..., 0]) | (plain[..., 1].to(torch.int64) << 32)


def mix_keys(x_plain: torch.Tensor, y_plain: torch.Tensor) -> torch.Tensor:
    """``_mix_keys`` on the device: plain limbs (..., 8) of x and y -> int64
    bit patterns of the uint64 keys."""
    return (_low64(x_plain) * _MIX1_I64) ^ (_low64(y_plain) * _MIX2_I64)


def _affine_plain(P: PointW):
    """-> (x, y, inf) of a point batch, x and y as plain limbs (the
    reference's from_mont of to_affine): one inverse and three products."""
    x, y, inf = E2.to_affine(P)
    one = to_tensor(int_to_limbs(1), P.device)
    xy = E2.F.mul(torch.stack([x, y]), one)
    return xy[0], xy[1], inf


def giant_stride(n: int, max_steps: int, stride_k: int = 32) -> int:
    """K, the giant steps one round of ``dlog_batch`` takes for a batch of
    n points (2 * n * K candidates a round).  The adaptive stride widens K,
    bounded by a ~2^21-candidate budget, so deep searches take few
    rounds."""
    if max_steps > 64 * stride_k:
        stride_k = int(min(4096, max(stride_k, max_steps // 512),
                           max(32, (1 << 21) // max(n, 1))))
    return stride_k


class BsgsTable:
    """Sorted-key baby-step table for dlog of bounded-magnitude messages.

    ``keys_sorted`` (uint64, sorted unsigned) and ``perm`` (int64, perm[i] = j
    such that keys_sorted[i] = key(j*G)) are the reference's host arrays; the
    device copies used by lookups are made from them, or they from the
    device copies, when first asked for."""

    def __init__(self, m: int, keys_sorted: Optional[np.ndarray] = None,
                 perm: Optional[np.ndarray] = None, _device=None):
        self.m = m
        self._keys_sorted = keys_sorted
        self._perm = perm
        #: device str -> (keys XOR 2^63 sorted ascending, perm), int64
        self._dev = dict(_device or {})
        #: (K, device str) -> the giant-step strides of dlog_batch
        self._strides = {}
        #: giant-step rounds of the last dlog_batch call
        self.last_rounds = 0

    @property
    def keys_sorted(self) -> np.ndarray:
        if self._keys_sorted is None:
            flipped, _ = next(iter(self._dev.values()))
            self._keys_sorted = (flipped ^ _SIGN).cpu().numpy().view(np.uint64)
        return self._keys_sorted

    @property
    def perm(self) -> np.ndarray:
        if self._perm is None:
            _, perm = next(iter(self._dev.values()))
            self._perm = perm.cpu().numpy()
        return self._perm

    def device_arrays(self, device):
        """(keys XOR 2^63 sorted ascending, perm) as int64 tensors on
        ``device``."""
        key = str(device)
        if key not in self._dev:
            flipped = self.keys_sorted.view(np.int64) ^ np.int64(_SIGN)
            self._dev[key] = (torch.from_numpy(flipped).to(device),
                              torch.from_numpy(np.asarray(self.perm,
                                                          dtype=np.int64)
                                               ).to(device))
        return self._dev[key]

    # ------------------------------------------------------------------

    @staticmethod
    def build(m: int = 3_200_000, chunk: int = 1 << 18,
              cache_path: Optional[str] = None, device=None) -> "BsgsTable":
        """The table for j in [1, m), from ``cache_path`` when it holds one
        for this m, else built on ``device`` (and written there)."""
        if cache_path and os.path.exists(cache_path):
            with open(cache_path, "rb") as fh:
                data = pickle.load(fh)
            if data["m"] == m:
                return BsgsTable(m, data["keys"], data["perm"])

        dev = resolve_device(device)
        chunk = min(chunk, m)
        # seed chunk: j*G for j in [1, chunk] by doubling blocks
        pts = E2.generator((1,), dev)
        size = 1
        while size < chunk:
            step = min(size, chunk - size)
            stride = E2.from_affine_host([size * E2_G_HOST], dev)
            pts = cat_points([pts, E2.add(take(pts, slice(0, step)), stride)])
            size += step

        stride = E2.from_affine_host([chunk * E2_G_HOST], dev)
        keys_list = []
        j_base = 1
        cur = pts
        while j_base < m:
            count = min(chunk, m - j_base)
            x, y, _ = _affine_plain(take(cur, slice(0, count)))
            keys_list.append(mix_keys(x, y))
            j_base += count
            if j_base < m:
                cur = E2.add(cur, stride)

        keys = torch.cat(keys_list)
        js = torch.arange(1, m, dtype=torch.int64, device=dev)
        # a stable sort of the flipped keys is the reference's stable
        # unsigned argsort, ties in ascending j
        flipped, order = torch.sort(keys ^ _SIGN, stable=True)
        table = BsgsTable(m, _device={str(dev): (flipped, js[order])})
        if cache_path:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            with open(cache_path, "wb") as fh:
                pickle.dump({"m": m, "keys": table.keys_sorted,
                             "perm": table.perm}, fh)
        return table

    # ------------------------------------------------------------------

    def strides(self, K: int, device):
        """(S, hop) on ``device``: S (1, K) holds i * (-m G) for i in [0, K),
        hop (1,) is -K m G.  S is built by doubling blocks, one K2 launch
        per doubling (the reference adds K host points one by one), and
        both are kept for the next call with the same K."""
        key = (K, str(device))
        if key not in self._strides:
            step = (-self.m) % E2_ORDER * E2_G_HOST
            S = E2.from_affine_host([0 * E2_G_HOST, step], device)
            size = 2
            while size < K:
                n = min(size, K - size)
                shift = E2.from_affine_host([size * step], device)
                S = cat_points([S, E2.add(take(S, slice(0, n)), shift)])
                size += n
            S = take(S, slice(0, K))
            hop = E2.from_affine_host(
                [(-(K * self.m)) % E2_ORDER * E2_G_HOST], device)
            self._strides[key] = (PointW(*(c[None] for c in S)), hop)
        return self._strides[key]

    def _lookup(self, x_plain: torch.Tensor, y_plain: torch.Tensor
                ) -> torch.Tensor:
        """Plain limbs (..., 8) of affine x and y -> j candidates (int64),
        -1 where no key matches."""
        flipped, perm = self.device_arrays(x_plain.device)
        q = mix_keys(x_plain, y_plain) ^ _SIGN
        pos = torch.searchsorted(flipped, q.reshape(-1)).clamp_(
            0, flipped.shape[0] - 1)
        hit = flipped[pos] == q.reshape(-1)
        return torch.where(hit, perm[pos], -1).reshape(q.shape)

    def dlog_batch(self, M: PointW, max_steps: Optional[int] = None,
                   stride_k: int = 32) -> list:
        """Signed dlog of a flat batch of m*G points.  Walks both the +M
        and -M chains (reference dual-chain negative handling,
        cnn_networks/Client.py:228-231)."""
        dev = M.device
        n = M.batch_shape[0]
        # default = m giant steps, the reference's cap (giant_step loops up
        # to m times, cnn_networks/Client.py:188-213); the early break
        # below keeps small values as cheap as a small cap would
        max_steps = max_steps if max_steps is not None else self.m
        K = giant_stride(n, max_steps, stride_k)
        # chains: rows [0, n) walk +M, rows [n, 2n) walk -M
        chains = cat_points([M, E2.neg(M)])

        # stride candidates -i*m*G for i in 0..K-1, and the round hop -K*m*G
        S, hop = self.strides(K, dev)

        found = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
        rounds = (max_steps + K - 1) // K
        self.last_rounds = 0
        for r in range(rounds):
            self.last_rounds = r + 1
            cand = E2.add(PointW(*(c[:, None] for c in chains)), S)  # (2n, K)
            x, y, inf = _affine_plain(cand)
            js = self._lookup(x, y)
            # an infinity candidate means M == (step*m)*G exactly
            hit = inf | (js >= 0)
            any_hit = hit.any(-1)
            i_first = hit.to(torch.uint8).argmax(-1, keepdim=True)
            j_at = js.gather(-1, i_first)[:, 0]
            inf_at = inf.gather(-1, i_first)[:, 0]
            val = (r * K + i_first[:, 0]) * self.m + torch.where(inf_at, 0,
                                                                 j_at)
            found = torch.where(any_hit & (found == -1), val, found)
            if bool(((found[:n] != -1) | (found[n:] != -1)).all()):
                break
            chains = E2.add(chains, hop)

        found = found.cpu().numpy()
        pos, neg = found[:n], found[n:]
        missing = (pos == -1) & (neg == -1)
        if missing.any():
            raise ValueError(f"dlog not found within {max_steps} giant steps "
                             f"for {int(missing.sum())} elements")
        use_pos = (pos != -1) & ((neg == -1) | (pos <= neg))
        results = [int(p) if up else -int(ng)
                   for p, ng, up in zip(pos, neg, use_pos)]

        # verification sweep: |v|*G must reproduce +/-M (guards key collisions)
        absvals = [abs(v) for v in results]
        nb = max(1, max((v.bit_length() for v in absvals), default=1))
        vg = E2.scalar_mul_bits(E2.generator((n,), dev),
                                scalars_to_bits(absvals, nb))
        signs = np.asarray([v < 0 for v in results], dtype=bool)
        vg = E2.select(signs, E2.neg(vg), vg)
        if not bool(E2.eq(vg, M).all()):
            raise ValueError("BSGS verification failed (hash collision?)")
        return results
