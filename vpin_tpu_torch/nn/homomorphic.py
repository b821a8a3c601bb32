"""Homomorphic conv over ElGamal ciphertext halves, with the rLC check.

Port of vpin_tpu/nn/homomorphic.py (conv2d; pooling, FC and channel sums
come with the CNN slice).  Reference: src/cnn_networks/Server.py:268-323
(conv) and :151-266 (rLC, a Freivalds check).

Points are PointW batches; sliding windows are gathers; every scalar
multiplication of a batch is one K3 launch (the whole ladder) and every
level of a point sum one K2 launch.  The witness trace records the same
operations, in the same order, as the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..curve.weierstrass import E2, PointW, cat_points, scalars_to_bits, take
from ..field.limbs import N_LIMBS
from .prf import pf_vector
from .trace import WitnessTrace


def _window_indices(H, W, f, padding, stride):
    """Static (M, f*f) gather indices into the padded (H+2p)x(W+2p) image.
    Row-major over output pixels, then row-major over the filter — the same
    iteration order as the reference's loops."""
    Hp, Wp = H + 2 * padding, W + 2 * padding
    OH = (Hp - f) // stride + 1
    OW = (Wp - f) // stride + 1
    i = np.arange(OH)[:, None, None, None] * stride
    j = np.arange(OW)[None, :, None, None] * stride
    ii = np.arange(f)[None, None, :, None]
    jj = np.arange(f)[None, None, None, :]
    idx = ((i + ii) * Wp + (j + jj)).reshape(OH * OW, f * f).astype(np.int32)
    return idx, OH, OW


def _pad_infinity(P: PointW, padding: int) -> PointW:
    """Surround an (H, W) point image with the identity point
    (reference pads with identityPoint, Server.py:278)."""
    if padding == 0:
        return P
    H, W = P.batch_shape
    inf_row = E2.infinity((padding, W + 2 * padding), P.device)
    inf_col = E2.infinity((H, padding), P.device)
    withcols = cat_points([inf_col, P, inf_col], dim=1)
    return cat_points([inf_row, withcols, inf_row], dim=0)


def _gather(P: PointW, idx) -> PointW:
    index = torch.as_tensor(idx, dtype=torch.int64, device=P.device)
    return PointW(*(c.reshape(-1, N_LIMBS)[index] for c in P))


def _signed_const_mul(P: PointW, weights: np.ndarray) -> PointW:
    """[w]P elementwise for a static integer weight array broadcastable to
    P's batch shape; negative weights via point negation."""
    w = np.asarray(weights, dtype=object)
    absw = np.vectorize(lambda v: abs(int(v)), otypes=[object])(w)
    n_bits = max(1, max(int(v).bit_length() for v in absw.reshape(-1)))
    out = E2.scalar_mul_bits(P, scalars_to_bits(absw, n_bits))
    neg_mask = np.vectorize(lambda v: int(v) < 0, otypes=[bool])(w)
    if neg_mask.any():
        out = E2.select(np.broadcast_to(neg_mask, out.batch_shape),
                        E2.neg(out), out)
    return out


class RLCCheckError(AssertionError):
    pass


class HomomorphicEngine:
    """Server-side encrypted-inference layers with rLC verification.

    Each conv queues a device boolean; flush_checks() fetches them and
    raises on a mismatch (the reference's inline
    ``assert result_left == result_right``, Server.py:321), so the host
    waits for the device once per request, not once per layer."""

    def __init__(self, trace: Optional[WitnessTrace] = None,
                 prf_trunc_bytes: int = 14):
        self.trace = trace if trace is not None else WitnessTrace()
        self.prf_trunc_bytes = prf_trunc_bytes
        self.pending_checks = []

    def _prefix_adds(self, terms: PointW):
        """Running sums acc_t = sum(terms[0..t]) along axis 0, one K2
        launch per step; returns (accs (n, ...), final acc (...))."""
        acc = take(terms, 0)
        accs = [acc]
        for t in range(1, terms.batch_shape[0]):
            acc = E2.add(acc, take(terms, t))
            accs.append(acc)
        return PointW(*(torch.stack([a[i] for a in accs]) for i in range(3))), acc

    def _record_chain(self, terms: PointW):
        """Record the (n-1) running-sum additions of a term chain, in order;
        returns the final sum."""
        accs, final = self._prefix_adds(terms)
        left = take(accs, slice(0, -1))
        right = take(terms, slice(1, None))
        self.trace.record_adds(left, right)
        return final

    def conv2d(self, P: PointW, filt: np.ndarray, key: bytes,
               padding: int = 0, stride: int = 1) -> PointW:
        """Homomorphic conv of one (H, W) ciphertext half by an integer
        filter, with the rLC verification emitting f^2 recorded mults and
        f^2-1 recorded adds (the witness-collapse trick of the paper)."""
        H, W = P.batch_shape
        filt = np.asarray(filt)
        f = filt.shape[0]
        idx, OH, OW = _window_indices(H, W, f, padding, stride)
        M = idx.shape[0]

        win = _gather(_pad_infinity(P, padding), idx)          # (M, f^2)
        wflat = filt.reshape(-1)

        # unrecorded homomorphic conv output
        terms = _signed_const_mul(win, wflat[None, :])
        out = E2.sum_points(terms, axis=1)                     # (M,)

        # rLC left: sum_m rho_m * out_m
        rho = pf_vector(key, M, self.prf_trunc_bytes)
        rho_bits = scalars_to_bits(rho, 8 * self.prf_trunc_bytes)
        left = E2.sum_points(E2.scalar_mul_bits(out, rho_bits), axis=0)

        # rLC right: combine windows first (unrecorded), then f^2 recorded
        # mults by the plain kernel weights + a recorded add chain.
        comb_terms = E2.scalar_mul_bits(win, rho_bits[:, None, :])
        combined = E2.sum_points(comb_terms, axis=0)           # (f^2,)
        temp = _signed_const_mul(combined, wflat)
        self.trace.record_mults(combined, [int(v) for v in wflat])
        right = self._record_chain(temp)

        self.pending_checks.append(E2.eq(left, right))
        return PointW(*(c.reshape(OH, OW, N_LIMBS) for c in out))

    def flush_checks(self):
        """Fetch all queued rLC equality checks; raise on a mismatch."""
        oks = [bool(c.all()) for c in self.pending_checks]
        self.pending_checks = []
        if not all(oks):
            bad = [i for i, ok in enumerate(oks) if not ok]
            raise RLCCheckError(f"rLC verification failed for checks {bad}")
        return True
