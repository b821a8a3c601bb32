"""Exponential ElGamal over curve E2, batched on the device.

Port of vpin_tpu/nn/elgamal.py (reference: src/convolution/Client.py:19-30
encrypt; src/cnn_networks/Client.py:215-249 decrypt).
  Enc(m) = (c1, c2) = (r*G, m*G + r*h), r random in [1, q-2], drawn from the
           caller's random.Random in the reference's order, so the same seed
           gives the same ciphertexts as vpin_tpu;
  Dec    = dlog(c2 - x*c1) by baby-step/giant-step (nn/bsgs.py), trying both
           +M and -M to recover signed messages.
Spans (utils/timer): encrypt_nonces (the host's draws and digits) and
encrypt_tables tile encrypt_batch; decrypt_ladder, then dlog_batch's
bsgs_search and bsgs_verify, tile decrypt_batch.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..curve.fixed_base import FixedBaseTable, scalars_to_digits
from ..curve.host_ec import E2_G_HOST, E2_ORDER, HostPoint
from ..curve.weierstrass import E2, PointW, scalars_to_bits, take
from ..device import resolve_device
from ..utils.timer import span
from .bsgs import BsgsTable


class CipherTensor(NamedTuple):
    """A batch of ElGamal ciphertexts: two point batches of equal shape."""
    c1: PointW
    c2: PointW

    @property
    def batch_shape(self):
        return self.c1.batch_shape


_G_TABLES: dict = {}


def g_table(device: torch.device) -> FixedBaseTable:
    """The generator's digit table on ``device``, built once per process."""
    key = str(device)
    if key not in _G_TABLES:
        _G_TABLES[key] = FixedBaseTable(E2, E2_G_HOST, device)
    return _G_TABLES[key]


@dataclass
class KeyPair:
    x: int                 # secret
    h_host: HostPoint      # public h = x*G
    h_dev: PointW          # device copy, batch shape ()
    _h_table: Optional[FixedBaseTable] = field(default=None, repr=False,
                                               compare=False)

    @staticmethod
    def generate(rng: Optional[random.Random] = None,
                 device=None) -> "KeyPair":
        rng = rng or random.Random()
        return KeyPair.from_secret(rng.randrange(1, E2_ORDER - 1), device)

    @staticmethod
    def from_secret(x: int, device=None) -> "KeyPair":
        h = x * E2_G_HOST
        h_dev = take(E2.from_affine_host([h], resolve_device(device)), 0)
        return KeyPair(x, h, h_dev)

    @property
    def device(self) -> torch.device:
        return self.h_dev.device

    @property
    def h_table(self) -> FixedBaseTable:
        if self._h_table is None:
            self._h_table = FixedBaseTable(E2, self.h_host, self.device)
        return self._h_table


def encrypt_batch(messages, key: KeyPair,
                  rng: Optional[random.Random] = None) -> CipherTensor:
    """Encrypt a host integer array (any shape) on the key's device."""
    with span("encrypt_nonces"):
        rng = rng or random.Random()
        arr = np.asarray(messages, dtype=object)
        flat = [int(v) for v in arr.reshape(-1)]
        rs = [rng.randrange(1, E2_ORDER - 1) for _ in range(len(flat))]
        r_digits = scalars_to_digits(
            np.asarray(rs, dtype=object).reshape(arr.shape))
        absm = np.asarray([abs(v) for v in flat],
                          dtype=object).reshape(arr.shape)
        m_digits = scalars_to_digits(absm)
        neg = np.asarray([v < 0 for v in flat], dtype=bool).reshape(arr.shape)

    with span("encrypt_tables"):
        G = g_table(key.device)
        c1 = G.mul(r_digits)
        rh = key.h_table.mul(r_digits)
        mg = G.mul(m_digits)
        if neg.any():
            mg = E2.select(neg, E2.neg(mg), mg)
        c2 = E2.add(mg, rh)
    return CipherTensor(c1, c2)


def decrypt_batch(ct: CipherTensor, key: KeyPair, table: BsgsTable,
                  max_steps: Optional[int] = None) -> np.ndarray:
    """Decrypt to signed host integers (an object array of the ciphertexts'
    batch shape): one 253-bit K3 ladder of c1 by the secret x, one K2
    subtraction, then the batched BSGS search (reference: Client.py
    decrypt_c1_c2 + giant_step)."""
    shape = ct.batch_shape
    with span("decrypt_ladder"):
        c1 = PointW(*(c.reshape(-1, c.shape[-1]) for c in ct.c1))
        c2 = PointW(*(c.reshape(-1, c.shape[-1]) for c in ct.c2))
        s = E2.scalar_mul_bits(c1, scalars_to_bits(key.x, 253))
        M = E2.add(c2, E2.neg(s))           # m*G
    # spans bsgs_search and bsgs_verify
    vals = table.dlog_batch(M, max_steps=max_steps)
    return np.asarray(vals, dtype=object).reshape(shape)
