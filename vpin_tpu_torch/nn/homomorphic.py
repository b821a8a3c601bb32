"""Homomorphic CNN layers over ElGamal ciphertext halves, with the rLC check.

Port of vpin_tpu/nn/homomorphic.py.  Reference:
  conv   : src/cnn_networks/Server.py:268-323 (myConv2d, type==1)
  rLC    : src/cnn_networks/Server.py:151-266 (rLCL/rLCR), a Freivalds check
  pool   : src/cnn_networks/Server.py:358-429 (myAvgPool2d)
  FC     : src/cnn_networks/Server.py:439-470 (FCLayer)
  channel sums: src/LeNet/Server.py:545-551

Points are PointW batches; sliding windows are gathers; every scalar
multiplication of a batch is one K3 launch (the whole ladder) and every
level of a point sum one K2 launch.  The witness trace records the same
operations, in the same order, as the reference.  Spans (utils/timer) tile
conv2d and fc: layer_products (the unrecorded product), rlc_scalars (the
host's rLC scalars and their bits), rlc_left and rlc_right.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..curve.host_ec import E2_ORDER
from ..curve.weierstrass import E2, PointW, cat_points, scalars_to_bits, take
from ..field.limbs import N_LIMBS
from ..utils.timer import span
from . import fixed_point
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
        out = E2.select(np.array(np.broadcast_to(neg_mask, out.batch_shape)),
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
        wflat = filt.reshape(-1)

        # unrecorded homomorphic conv output
        with span("layer_products"):
            idx, OH, OW = _window_indices(H, W, f, padding, stride)
            M = idx.shape[0]
            win = _gather(_pad_infinity(P, padding), idx)      # (M, f^2)
            terms = _signed_const_mul(win, wflat[None, :])
            out = E2.sum_points(terms, axis=1)                 # (M,)

        with span("rlc_scalars"):
            rho = pf_vector(key, M, self.prf_trunc_bytes)
            rho_bits = scalars_to_bits(rho, 8 * self.prf_trunc_bytes)

        # rLC left: sum_m rho_m * out_m
        with span("rlc_left"):
            left = E2.sum_points(E2.scalar_mul_bits(out, rho_bits), axis=0)

        # rLC right: combine windows first (unrecorded), then f^2 recorded
        # mults by the plain kernel weights + a recorded add chain.
        with span("rlc_right"):
            comb_terms = E2.scalar_mul_bits(win, rho_bits[:, None, :])
            combined = E2.sum_points(comb_terms, axis=0)       # (f^2,)
            temp = _signed_const_mul(combined, wflat)
            self.trace.record_mults(combined, [int(v) for v in wflat])
            right = self._record_chain(temp)
            self.pending_checks.append(E2.eq(left, right))
        return PointW(*(c.reshape(OH, OW, N_LIMBS) for c in out))

    def avgpool2d(self, P: PointW, kernel_size: int, stride: int) -> PointW:
        """Homomorphic average pool: recorded window-sum adds (pixel-major),
        then an unrecorded mult by fixed_point(1/k^2, 10 bits)
        (reference: Server.py:358-429)."""
        H, W = P.batch_shape
        k = kernel_size
        idx, OH, OW = _window_indices(H, W, k, 0, stride)
        win = _gather(P, idx)                                  # (M, k^2)
        winT = PointW(*(c.transpose(0, 1) for c in win))       # (k^2, M)
        accs, final = self._prefix_adds(winT)
        # record in pixel-major order: (M, k^2-1)
        left = PointW(*(c[:-1].transpose(0, 1) for c in accs))
        right = PointW(*(c[1:].transpose(0, 1) for c in winT))
        self.trace.record_adds(left, right)
        scale = fixed_point.pool_reciprocal_fixed(k)
        out = _signed_const_mul(final, np.full((final.batch_shape[0],), scale,
                                               dtype=object))
        return PointW(*(c.reshape(OH, OW, N_LIMBS) for c in out))

    def fc(self, P: PointW, weights: np.ndarray, bias: PointW,
           key: bytes) -> PointW:
        """Homomorphic fully-connected layer on a (n_in,) ciphertext half.

        weights: (n_in, n_out) integer matrix; bias: (n_out,) encrypted
        points.  Records n_out bias adds, then n_in rLC mults by the
        rho-combined weight columns (exact integers, the reference's Decimal
        path, Server.py:226-250), then n_in-1 rLC adds."""
        n_in, n_out = weights.shape
        if P.batch_shape != (n_in,):
            raise ValueError(f"fc: {P.batch_shape} inputs for {n_in} rows")

        with span("layer_products"):
            # C[j] = sum_k W[k, j] * P[k]   (unrecorded)
            Pb = PointW(*(c[:, None, :] for c in P))
            terms = _signed_const_mul(Pb, weights)             # (n_in, n_out)
            C = E2.sum_points(terms, axis=0)                   # (n_out,)
            # bias adds (recorded)
            self.trace.record_adds(C, bias)
            out = E2.add(C, bias)

        with span("rlc_scalars"):
            rho = pf_vector(key, n_out, self.prf_trunc_bytes)
            rho_bits = scalars_to_bits(rho, 8 * self.prf_trunc_bytes)

        # rLC left over C
        with span("rlc_left"):
            left = E2.sum_points(E2.scalar_mul_bits(C, rho_bits), axis=0)

        # Combined column weights in exact integers, worked out on the host
        # while the card runs the left side's ladders.  Signed weights make
        # them signed, so the witness is recorded sign-folded, (sign(s)*P,
        # |s|): homomorphically the same and fit for the 128-bit mult
        # gadget.  Where |s| still needs more than 128 bits it is reduced
        # mod the E2 group order, and the prover takes the 253-bit gadget.
        with span("rlc_scalars"):
            s = [sum(int(rho[j]) * int(weights[kk, j]) for j in range(n_out))
                 for kk in range(n_in)]
            s_rec = []
            neg = np.zeros((n_in,), dtype=bool)
            for i, v in enumerate(s):
                if abs(v) < (1 << 128):
                    neg[i] = v < 0
                    s_rec.append(abs(v))
                else:
                    s_rec.append(v % E2_ORDER)
            n_bits = max(1, max(v.bit_length() for v in s_rec))
            s_bits = scalars_to_bits(s_rec, n_bits)

        with span("rlc_right"):
            P_eff = E2.select(neg, E2.neg(P), P) if neg.any() else P
            temp = E2.scalar_mul_bits(P_eff, s_bits)
            self.trace.record_mults(P_eff, s_rec)
            right = self._record_chain(temp)
            self.pending_checks.append(E2.eq(left, right))
        return out

    def flush_checks(self):
        """Fetch all queued rLC equality checks; raise on a mismatch."""
        oks = [bool(c.all()) for c in self.pending_checks]
        self.pending_checks = []
        if not all(oks):
            bad = [i for i, ok in enumerate(oks) if not ok]
            raise RLCCheckError(f"rLC verification failed for checks {bad}")
        return True


def channel_sum(channels: list) -> PointW:
    """Elementwise point sum of a list of (H, W) ciphertext halves (LeNet's
    conv2/conv3 input aggregation, reference LeNet/Server.py:545-551;
    unrecorded)."""
    stacked = PointW(*(torch.stack([c[i] for c in channels]) for i in range(3)))
    return E2.sum_points(stacked, axis=0)
