"""Freivalds-check PRF: HMAC-SHA256 truncated per workload.

Behavioral spec from the reference (`pf`):
  - convolution workload: 16-byte truncation (src/convolution/Server.py:83-88)
  - CNN A-E workload:     14-byte truncation (src/cnn_networks/Server.py:406-411)
  - LeNet workload:       13-byte truncation (src/LeNet/Server.py:284-289)
The counter is the decimal string of the index, utf-8 encoded.
"""

from __future__ import annotations

import hmac
import hashlib
import os


def pf(secret_key: bytes, index: int, trunc_bytes: int) -> int:
    digest = hmac.new(secret_key, str(index).encode("utf-8"), hashlib.sha256).digest()
    return int.from_bytes(digest[:trunc_bytes], "big")


def pf_vector(secret_key: bytes, n: int, trunc_bytes: int) -> list:
    return [pf(secret_key, i, trunc_bytes) for i in range(n)]


def fresh_key() -> bytes:
    """Per-layer rLC key (reference: os.urandom(32) per conv/FC call)."""
    return os.urandom(32)
