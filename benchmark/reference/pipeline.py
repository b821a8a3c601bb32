"""The served pipelines of vPIN in plain Python and NumPy: the reference that
decides whether a served request is correct.

Every ciphertext point of the protocol is a known multiple of E2's
generator, so each point is tracked as its discrete log mod q: ElGamal
encryption of v with nonce r is (r, v + x r), decryption is c2 - x c1, a
homomorphic sum is a sum of logs, a scalar multiplication a product.  The
pipelines below follow the vPIN reference (src/convolution/Server.py and
src/cnn_networks/Server.py, Client.py): the same nonce draws in the same
order, the same rLC combinations from HMAC-SHA256, the same recorded
witness in the same order, the same fixed-point steps through float32.
``fraction_bits`` is the fixed-point precision the configuration states;
the control computes at one bit fewer.

They take only what the benchmark made: the image, the weights, the secret
key, the nonce generator's seed and the rLC keys.
"""

from __future__ import annotations

import hashlib
import hmac
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import numpy as np

from .e2 import ORDER as Q
from .e2 import signed

# ---------------------------------------------------------------- fixed point
# (src/convolution/Client.py:65-118, cnn_networks/Client.py:273-276,
# cnn_networks/Server.py:396-402)


def encode(x, bits: int) -> np.ndarray:
    return (np.asarray(x) * (2 ** bits)).astype(np.int32)


def decode(fixed, bits: int) -> np.ndarray:
    return np.array(fixed, dtype=np.float32) / (2 ** bits)


def shift(values, bits: int, fraction_bits: int) -> np.ndarray:
    return encode(decode(values, bits), fraction_bits)


def min_max_scaling(images) -> np.ndarray:
    images = np.asarray(images)
    lo, hi = np.min(images), np.max(images)
    out = (images - lo) / (hi - lo)
    return np.clip(out, a_min=0.001, a_max=0.9999999)


def pool_reciprocal_fixed(kernel_size: int, bits: int = 10) -> int:
    return int((1.0 / (kernel_size ** 2)) * (2 ** bits))


# ------------------------------------------------------------------- the PRF


def pf_vector(secret_key: bytes, n: int, trunc_bytes: int) -> List[int]:
    """HMAC-SHA256 of the decimal index, truncated (Server.py:83-88)."""
    return [int.from_bytes(hmac.new(secret_key, str(i).encode(),
                                    hashlib.sha256).digest()[:trunc_bytes],
                           "big") for i in range(n)]


def window_indices(H: int, W: int, f: int, padding: int, stride: int):
    """(M, f*f) indices into the padded image, row-major over the output
    pixels, then over the filter (the reference's loop order)."""
    Hp, Wp = H + 2 * padding, W + 2 * padding
    OH = (Hp - f) // stride + 1
    OW = (Wp - f) // stride + 1
    i = np.arange(OH)[:, None, None, None] * stride
    j = np.arange(OW)[None, :, None, None] * stride
    ii = np.arange(f)[None, None, :, None]
    jj = np.arange(f)[None, None, None, :]
    return ((i + ii) * Wp + (j + jj)).reshape(OH * OW, f * f), OH, OW


# ------------------------------------------------------------ the witness


@dataclass
class Witness:
    """The recorded EC operations, as logs: mults (base, scalar) and adds
    (left, right), in the order the protocol records them."""
    mult_bases: List[int] = field(default_factory=list)
    mult_scalars: List[int] = field(default_factory=list)
    add_left: List[int] = field(default_factory=list)
    add_right: List[int] = field(default_factory=list)

    def chain(self, terms: List[int]) -> int:
        """Record the running-sum additions of ``terms``; their sum."""
        acc = terms[0]
        for t in terms[1:]:
            self.add_left.append(acc)
            self.add_right.append(t)
            acc = (acc + t) % Q
        return acc


def _obj(a) -> np.ndarray:
    return np.asarray(a, dtype=object)


class Client:
    """The client's side: encryptions (nonces from ``rng`` in the order the
    reference draws them), decryptions, ReLU and shifts."""

    def __init__(self, x: int, rng: random.Random, fraction_bits: int):
        self.x, self.rng, self.fb = x, rng, fraction_bits

    def encrypt(self, values):
        v = np.asarray(values)
        flat = [int(t) for t in v.reshape(-1)]
        rs = [self.rng.randrange(1, Q - 1) for _ in flat]
        c1 = _obj(rs).reshape(v.shape)
        c2 = _obj([(m + self.x * r) % Q for m, r in zip(flat, rs)]).reshape(v.shape)
        return c1, c2

    def decrypt(self, ct) -> np.ndarray:
        c1, c2 = ct
        return _obj([signed(b - self.x * a) for a, b in
                     zip(c1.reshape(-1), c2.reshape(-1))]).reshape(c1.shape)

    def interact(self, ct, relu: bool, shift_bits, seen: list):
        vals = self.decrypt(ct)
        seen.append(vals)
        out = np.asarray(vals.tolist(), dtype=np.int64)
        if relu:
            out = np.maximum(0, out)
        if shift_bits is not None:
            out = shift(out, shift_bits, self.fb)
        return self.encrypt(out)


def conv_half(P: np.ndarray, filt: np.ndarray, key: bytes, trunc: int,
              padding: int, stride: int, wit: Witness, pixels=None):
    """One ciphertext half (an (H, W) array of logs) through the conv with
    its rLC check: records f^2 mults and f^2 - 1 adds into ``wit``; returns
    the output logs at ``pixels`` (flat output indices; all when None) and
    the output shape."""
    H, W = P.shape
    f = filt.shape[0]
    idx, OH, OW = window_indices(H, W, f, padding, stride)
    padded = np.zeros((H + 2 * padding, W + 2 * padding), dtype=object)
    padded[padding:padding + H, padding:padding + W] = P
    win = padded.reshape(-1)[idx]                               # (M, f^2)
    wflat = [int(w) for w in filt.reshape(-1)]
    rows = win if pixels is None else win[np.asarray(pixels, dtype=np.int64)]
    out = (rows * _obj(wflat)).sum(axis=1) % Q
    rho = _obj(pf_vector(key, idx.shape[0], trunc))
    combined = [int(c) % Q for c in (rho[:, None] * win).sum(axis=0)]
    wit.mult_bases.extend(combined)
    wit.mult_scalars.extend(wflat)
    wit.chain([w * c % Q for w, c in zip(wflat, combined)])
    return out, (OH, OW)


def pool_half(P: np.ndarray, k: int, s: int, wit: Witness) -> np.ndarray:
    """Average pool of one half: recorded window-sum adds, pixel-major, then
    the unrecorded scale; the (OH * OW,) logs."""
    H, W = P.shape
    idx, _, _ = window_indices(H, W, k, 0, s)
    win = P.reshape(-1)[idx]                                   # (M, k^2)
    scale = pool_reciprocal_fixed(k)
    return _obj([wit.chain([int(v) for v in row]) * scale % Q for row in win])


def fc_half(P: np.ndarray, Wm: np.ndarray, bias: np.ndarray, key: bytes,
            trunc: int, wit: Witness) -> np.ndarray:
    """FC on one half (Server.py:439-470, 226-250): the bias adds, then the
    rLC mults by the rho-combined columns, sign-folded below 2^128, and
    their add chain."""
    n_in, n_out = Wm.shape
    Wl = [[int(Wm[k, j]) for j in range(n_out)] for k in range(n_in)]
    Pl = [int(p) for p in P]
    C = [sum(Wl[k][j] * Pl[k] for k in range(n_in)) % Q for j in range(n_out)]
    bl = [int(b) for b in bias]
    wit.add_left.extend(C)
    wit.add_right.extend(bl)
    rho = pf_vector(key, n_out, trunc)
    temps = []
    for k in range(n_in):
        sk = sum(rho[j] * Wl[k][j] for j in range(n_out))
        if abs(sk) < (1 << 128):
            base, sc = (-Pl[k] % Q if sk < 0 else Pl[k]), abs(sk)
        else:
            base, sc = Pl[k], sk % Q
        wit.mult_bases.append(base)
        wit.mult_scalars.append(sc)
        temps.append(sc * base % Q)
    wit.chain(temps)
    return _obj([(c + b) % Q for c, b in zip(C, bl)])


@dataclass
class Served:
    witness: Witness
    #: the input ciphertext's halves, (H, W) logs each
    ciphertext: tuple = None
    #: conv: the output logs of each half at ``pixels``
    outputs: tuple = None
    pixels: list = None
    #: CNN: the logits, and each decryption's values in order
    logits: np.ndarray = None
    decrypted: list = None


def conv_request(cfg: Dict, image, x: int, nonce_seed: int,
                 keys: Callable[[], bytes], pixels=None,
                 fraction_bits: int = None) -> Served:
    """A single conv layer request (src/convolution): encrypt, conv each
    half with its rLC check, no decryption."""
    fb = cfg["fraction_bits"] if fraction_bits is None else fraction_bits
    client = Client(x, random.Random(nonce_seed), fb)
    ct = client.encrypt(encode(min_max_scaling(image), fb))
    filt = np.asarray(cfg["filter"])
    wit = Witness()
    outs = []
    for half in ct:
        out, _ = conv_half(half, filt, keys(), cfg["prf_trunc_bytes"],
                           cfg["padding"], cfg["stride"], wit, pixels)
        outs.append(out)
    return Served(wit, ciphertext=ct, outputs=tuple(outs), pixels=pixels)


def cnn_request(cfg: Dict, image, weights: Dict, x: int, nonce_seed: int,
                keys: Callable[[], bytes], fraction_bits: int = None) -> Served:
    """CNN A-E (src/cnn_networks/Server.py inferenceCNN): conv with rLC,
    ReLU, average pool, shift, FC1 with rLC, ReLU and shift, FC2 with rLC,
    the logits decrypted and ReLU'd."""
    fb = cfg["fraction_bits"] if fraction_bits is None else fraction_bits
    client = Client(x, random.Random(nonce_seed), fb)
    trunc = cfg["prf_trunc_bytes"]
    k, s = cfg["pool"]
    sh_pool, sh_fc = cfg["shifts"]
    wit, seen = Witness(), []
    ct = client.encrypt(encode(min_max_scaling(image), fb))
    filt = np.asarray(cfg["filter"])
    conv = []
    for half in ct:
        out, shape = conv_half(half, filt, keys(), trunc, cfg["padding"],
                               cfg["stride"], wit)
        conv.append(out.reshape(shape))
    ct = client.interact(conv, relu=True, shift_bits=None, seen=seen)
    pooled = [pool_half(h, k, s, wit) for h in ct]
    ct = client.interact(pooled, relu=False, shift_bits=sh_pool, seen=seen)
    for layer, sh in (("fc1", sh_fc), ("fc2", None)):
        Wm = encode(weights[f"weight_{layer}"], fb).astype(object)
        bias = client.encrypt(encode(weights[f"bias_{layer}"], fb))
        out = [fc_half(h, Wm, bias[i], keys(), trunc, wit)
               for i, h in enumerate(ct)]
        if sh is not None:
            ct = client.interact(out, relu=True, shift_bits=sh, seen=seen)
    vals = client.decrypt(tuple(out))
    seen.append(vals)
    logits = np.maximum(0, np.asarray(vals.tolist(), dtype=np.int64))
    return Served(wit, ciphertext=None, logits=logits, decrypted=seen)
