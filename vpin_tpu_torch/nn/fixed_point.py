"""Fixed-point codec, bit-compatible with the reference protocol.

Reference semantics (src/convolution/Client.py:65-84, cnn_networks/Client.py
shifting at :273-276): f=16 fractional bits on inputs/weights; after each
linear layer the client decodes at `bits` and re-encodes at 16.  The
reference routes the decode through float32 — we replicate that exactly
(including its precision loss) so accuracy behavior matches.
"""

from __future__ import annotations

import numpy as np

FRACTION_BITS = 16


def encode(x, bits: int = FRACTION_BITS) -> np.ndarray:
    """Real -> fixed point int32 (reference type==1 path)."""
    return (np.asarray(x) * (2 ** bits)).astype(np.int32)


def encode_exact(x, bits: int):
    """Real -> scaled value without the int32 cast (reference type!=1 path)."""
    return np.asarray(x) * (2 ** bits)


def decode(fixed, bits: int) -> np.ndarray:
    """Fixed point -> real via float32, as the reference does."""
    return np.array(fixed, dtype=np.float32) / (2 ** bits)


def shift(values, bits: int) -> np.ndarray:
    """Rescale from `bits` fractional bits back to 16 (client 'shifting')."""
    return encode(decode(values, bits))


def min_max_scaling(images) -> np.ndarray:
    """Input normalization (reference: src/convolution/Client.py:110-118)."""
    images = np.asarray(images)
    lo, hi = np.min(images), np.max(images)
    out = (images - lo) / (hi - lo)
    return np.clip(out, a_min=0.001, a_max=0.9999999)


def pool_reciprocal_fixed(kernel_size: int, bits: int = 10) -> int:
    """AvgPool's unrecorded scale: int(1/k^2 * 2^bits)
    (reference: src/cnn_networks/Server.py:396-402)."""
    return int((1.0 / (kernel_size ** 2)) * (2 ** bits))
