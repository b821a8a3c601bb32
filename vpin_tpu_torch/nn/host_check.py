"""Exact host checks of a conv request, with the pure-Python curve arithmetic
of curve/host_ec.py as the oracle, and CNN A-E on plaintext integers.

Used by chip_smoke.py on the card's results and by the CPU tests.
"""

from __future__ import annotations

import numpy as np

from ..curve.host_ec import E2_HOST, HostPoint, host_infinity
from . import fixed_point
from .homomorphic import _window_indices


class HostCheckError(Exception):
    pass


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise HostCheckError(what)


def conv_pixels_host(image_pts: np.ndarray, filt: np.ndarray, pixels,
                     padding: int = 1, stride: int = 1) -> list:
    """The conv output at flat output pixels ``pixels`` of an (H, W) object
    array of affine HostPoints, summed on the host."""
    H, W = image_pts.shape
    f = filt.shape[0]
    idx, _, _ = _window_indices(H, W, f, padding, stride)
    padded = np.empty((H + 2 * padding, W + 2 * padding), dtype=object)
    padded.fill(host_infinity())
    padded[padding:padding + H, padding:padding + W] = image_pts
    flat = padded.reshape(-1)
    wflat = [int(v) for v in np.asarray(filt).reshape(-1)]
    out = []
    for m in pixels:
        acc = host_infinity()
        for t, w in enumerate(wflat):
            acc = acc + w * flat[idx[m, t]]
        out.append(acc)
    return out


def check_conv_outputs(image_pts: np.ndarray, out_pts: np.ndarray,
                       filt: np.ndarray, pixels, padding: int = 1,
                       stride: int = 1) -> None:
    """Raise unless the device's conv output equals the host's at
    ``pixels`` (flat indices into the (OH, OW) output)."""
    want = conv_pixels_host(image_pts, filt, pixels, padding, stride)
    got = out_pts.reshape(-1)
    for m, w in zip(pixels, want):
        _require(got[m] == w, f"conv output pixel {m} differs from host_ec")


def corner_pixels(OH: int, OW: int, n: int, seed: int = 0) -> list:
    """The four corners of an (OH, OW) output plus n - 4 other pixels drawn
    from ``seed``."""
    corners = sorted({0, OW - 1, (OH - 1) * OW, OH * OW - 1})
    rest = [m for m in range(OH * OW) if m not in corners]
    rng = np.random.RandomState(seed)
    extra = rng.choice(rest, size=min(max(n - len(corners), 0), len(rest)),
                       replace=False)
    return corners + sorted(int(m) for m in extra)


def _points(xs, ys, infs) -> list:
    return [HostPoint(E2_HOST, int(x), int(y), bool(i))
            for x, y, i in zip(xs, ys, infs)]


def check_conv_trace(fin: dict, filt: np.ndarray) -> None:
    """Raise unless a finalized conv trace is consistent: every point lies
    on E2, and per ciphertext half with weights w_t and recorded bases B_t,
    add_p[0] == w_0 B_0, add_r[t-1] == w_t B_t for t >= 1 and
    add_p[i+1] == add_p[i] + add_r[i]."""
    wflat = [int(v) for v in np.asarray(filt).reshape(-1)]
    f2 = len(wflat)
    bases = _points(fin["mult_px"], fin["mult_py"], fin["mult_inf"])
    lefts = _points(fin["add_px"], fin["add_py"], fin["add_p_inf"])
    rights = _points(fin["add_rx"], fin["add_ry"], fin["add_r_inf"])
    for P in bases + lefts + rights:
        _require(E2_HOST.is_on_curve(P), "trace point off the curve")
    halves = len(bases) // f2
    _require(len(bases) == halves * f2 and halves > 0,
             f"{len(bases)} recorded mults for a {f2}-weight filter")
    _require(len(lefts) == len(rights) == halves * (f2 - 1),
             f"{len(lefts)} recorded adds for {halves} halves")
    _require(list(fin["mult_scalars"]) == wflat * halves,
             "recorded scalars differ from the filter")
    for h in range(halves):
        B = bases[h * f2:(h + 1) * f2]
        Pl = lefts[h * (f2 - 1):(h + 1) * (f2 - 1)]
        Rr = rights[h * (f2 - 1):(h + 1) * (f2 - 1)]
        _require(Pl[0] == wflat[0] * B[0], f"half {h}: add_p[0] != w0 B0")
        for t in range(1, f2):
            _require(Rr[t - 1] == wflat[t] * B[t],
                     f"half {h}: add_r[{t - 1}] != w{t} B{t}")
        for i in range(f2 - 2):
            _require(Pl[i + 1] == Pl[i] + Rr[i],
                     f"half {h}: add_p[{i + 1}] != add_p[{i}] + add_r[{i}]")


def cnn_plain_decrypts(image: np.ndarray, weights: dict, version: str) -> list:
    """CNN ``version`` (A-E) on plaintext integers with the fixed-point steps
    of the encrypted pipeline: the values the client decrypts, in order (the
    conv output, the pooled sums, FC1's and FC2's outputs).  conv3 (pad 1)
    by the integer filter, ReLU, k x k window sums at stride s times
    fixed_point(1/k^2), shift 26, FC1 with the encoded weights plus the
    encoded bias, ReLU, shift 32, FC2; the logits are the last, ReLU'd."""
    from .models import CNN_CONFIGS, CONV_FILTERS
    _, _, k, s = CNN_CONFIGS[version]
    x = fixed_point.encode(fixed_point.min_max_scaling(image)).astype(np.int64)
    filt = CONV_FILTERS[3]
    H, W = x.shape
    xp = np.pad(x, 1)
    conv = sum(int(filt[a, b]) * xp[a:a + H, b:b + W]
               for a in range(3) for b in range(3))
    act = np.maximum(0, conv)
    idx, _, _ = _window_indices(H, W, k, 0, s)
    pooled = act.reshape(-1)[idx].sum(axis=1) \
        * fixed_point.pool_reciprocal_fixed(k)
    v = fixed_point.shift(pooled, 26).astype(np.int64)

    def fc(v, layer):
        w = fixed_point.encode(weights[f"weight_{layer}"]).astype(np.int64)
        b = fixed_point.encode(weights[f"bias_{layer}"]).astype(np.int64)
        return v @ w + b

    fc1 = fc(v, "fc1")
    h = fixed_point.shift(np.maximum(0, fc1), 32).astype(np.int64)
    return [conv.reshape(-1), pooled, fc1, fc(h, "fc2")]


def cnn_plain_logits(image: np.ndarray, weights: dict,
                     version: str) -> np.ndarray:
    """The logits of cnn_plain_decrypts."""
    return np.maximum(0, cnn_plain_decrypts(image, weights, version)[-1])
