"""Serving: one client in a closed loop, a fresh seeded image a request.

The configuration's ``kind`` says which pipeline serves it:
  conv  run_conv_workload: encrypt, the conv of both halves with the rLC
        checks flushed (src/convolution; no decryption)
  cnn   run_cnn_workload: encrypt, conv with rLC, the client's round trips
        (BSGS decrypt, ReLU or shift, re-encrypt), pool, FC1, FC2, the
        logits decrypted (src/cnn_networks)
Weights, images, the secret key, the nonces and the rLC keys are the
benchmark's, from the seed; the BSGS table is built in set-up.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from .. import inputs
from ..reference import e2, pipeline
from ..work import counts


class Driver:
    kind = "serve"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.mix = ctx.config, ctx.mix
        self.size = int(self.mix["size"])
        #: each finished request's decrypted logits (CNN), by request
        self.logits: Dict[int, np.ndarray] = {}
        #: the requests kept whole for the checks: a uniform sample drawn
        #: from the seed as the window runs (reservoir sampling), and the
        #: slowest so far; every other request is let go when it ends
        self.sample: List[Dict] = []
        self.slowest: Optional[Dict] = None
        self._draw = random.Random(inputs.subseed(ctx.seed, "sample",
                                                  "requests"))
        self._finished = 0
        self._refs: Dict[int, object] = {}
        self._work = None

    # ------------------------------------------------------------ set-up
    def setup(self):
        from vpin_tpu_torch.nn.elgamal import KeyPair
        seed, dev = self.ctx.seed, self.ctx.device
        self.x = inputs.secret_key(seed)
        self.key = KeyPair.from_secret(self.x, device=dev)
        if self.cfg["kind"] == "cnn":
            from vpin_tpu_torch.nn.bsgs import BsgsTable
            self.table = BsgsTable.build(self.cfg["bsgs_m"], device=dev)
            self.weights = inputs.weights(self.cfg["fc"],
                                          self.cfg["weight_scale"])
        for w in range(int(self.mix.get("warm_requests", 1))):
            self._serve(("warm", w))

    def _keys(self) -> int:
        return 2 if self.cfg["kind"] == "conv" else 6

    def _serve(self, req):
        from vpin_tpu_torch.nn.models import run_cnn_workload, run_conv_workload
        seed = self.ctx.seed
        img = inputs.image(seed, req, self.size)
        rng = random.Random(inputs.nonce_seed(seed, req))
        keys = inputs.key_source(inputs.rlc_keys(seed, req, self._keys()))
        if self.cfg["kind"] == "conv":
            return run_conv_workload(
                img, self.cfg["filter_size"], self.key, rng,
                padding=self.cfg["padding"], stride=self.cfg["stride"],
                key_source=keys)
        return run_cnn_workload(self.cfg["version"], img, self.key,
                                self.table, weights=self.weights, rng=rng,
                                key_source=keys, timed=self.ctx.trace)

    # -------------------------------------------------------------- steps
    def step(self, i: int) -> Dict:
        t = time.perf_counter()
        res = self._serve(i)
        took = time.perf_counter() - t
        if res.logits is not None:
            self.logits[i] = np.asarray(res.logits)
        self._keep({"req": i, "res": res, "took": took})
        return {"timings": dict(res.timings)}

    def _keep(self, entry: Dict):
        """Algorithm R over the finished requests, with one more slot for
        the slowest."""
        k = max(1, int(self.mix["check_requests"]) - 1)
        self._finished += 1
        if len(self.sample) < k:
            self.sample.append(entry)
        else:
            j = self._draw.randrange(self._finished)
            if j < k:
                self.sample[j] = entry
        if self.slowest is None or entry["took"] > self.slowest["took"]:
            self.slowest = entry

    def kept(self) -> Dict[int, Dict]:
        out = {e["req"]: e for e in self.sample}
        if self.slowest is not None:
            out[self.slowest["req"]] = self.slowest
        return out

    def release(self):
        """Keep on the host what the checks read; drop the device state."""
        for e in self.kept().values():
            res = e.pop("res", None)
            if res is None:
                continue
            e["trace"] = res.trace
            if self.cfg["kind"] == "conv":
                e["outputs"] = res.outputs
                e["ciphertext"] = res.ciphertext
        self.key = self.table = None

    def work(self, i: int) -> int:
        if self.cfg["kind"] == "conv":
            if self._work is None:
                self._work = counts.serve_conv(self.cfg, self.size)
            return self._work
        served = self._reference(i)
        fb = self.cfg["fraction_bits"]
        wf = {k: pipeline.encode(v, fb).astype(np.int64)
              for k, v in self.weights.items()}
        return counts.serve_cnn(self.cfg, self.size, wf, served.decrypted)

    # ------------------------------------------------------------- checks
    def _reference(self, req, pixels=None, fraction_bits=None):
        """The reference's request ``req``; a CNN request at the
        configuration's precision is worked out once and kept (whole for
        the requests kept for the checks, else its logits and decrypted
        values)."""
        cache = self.cfg["kind"] == "cnn" and fraction_bits is None
        if cache and req in self._refs:
            return self._refs[req]
        seed = self.ctx.seed
        img = inputs.image(seed, req, self.size)
        keys = inputs.key_source(inputs.rlc_keys(seed, req, self._keys()))
        ns = inputs.nonce_seed(seed, req)
        if self.cfg["kind"] == "conv":
            return pipeline.conv_request(self.cfg, img, self.x, ns, keys,
                                         pixels=pixels,
                                         fraction_bits=fraction_bits)
        ref = pipeline.cnn_request(self.cfg, img, self.weights, self.x, ns,
                                   keys, fraction_bits=fraction_bits)
        if cache:
            self._refs[req] = ref if req in self.kept() else \
                SimpleNamespace(logits=ref.logits, decrypted=ref.decrypted)
        return ref

    def checks(self) -> Dict[str, tuple]:
        lim = self.mix["limits"]
        # the control: the reference one fixed-point bit below the
        # configuration's precision, against what was served
        fraction_bits = (self.cfg["fraction_bits"] - 1
                         if self.ctx.control else None)
        kept = self.kept()
        out_bad = logit_bad = wit_bad = 0
        k = int(self.mix["check_points"])
        if self.cfg["kind"] == "cnn":
            for req in sorted(self.logits):
                ref = self._reference(req, fraction_bits=fraction_bits)
                logit_bad += int(not np.array_equal(
                    self.logits[req].reshape(-1), ref.logits.reshape(-1)))
                if req in kept:
                    wit_bad += witness_mismatch(kept[req]["trace"],
                                                ref.witness, self.ctx.seed,
                                                req, k)
        else:
            side = self.size + 2 * self.cfg["padding"] - len(self.cfg["filter"])
            out_side = side // self.cfg["stride"] + 1
            for req, e in sorted(kept.items()):
                pixels = corner_sample(self.ctx.seed, req, out_side, k)
                ref = self._reference(req, pixels=pixels,
                                      fraction_bits=fraction_bits)
                out_bad += output_mismatch(e["outputs"], ref, pixels)
                out_bad += input_mismatch(e["ciphertext"], ref, pixels)
                wit_bad += witness_mismatch(e["trace"], ref.witness,
                                            self.ctx.seed, req, k)
        got = {"witness_mismatch": (wit_bad, lim["witness_mismatch"])}
        if self.cfg["kind"] == "cnn":
            got["logits_mismatch"] = (logit_bad, lim["logits_mismatch"])
        else:
            got["output_mismatch"] = (out_bad, lim["output_mismatch"])
        return got


# --------------------------------------------------------------- comparison


def corner_sample(seed: int, req, side: int, k: int) -> List[int]:
    """k flat output pixels of a side x side output, its four corners among
    them, drawn from the seed."""
    corners = [0, side - 1, (side - 1) * side, side * side - 1]
    return inputs.sample(seed, ("pixels", req), side * side, k, corners)


def _point(limbs_xyz, flat_index: int):
    """(x, y, inf) of one point of a device batch (Montgomery limbs)."""
    from vpin_tpu_torch.curve.weierstrass import E2, PointW
    P = PointW(*(c.reshape(-1, c.shape[-1])[flat_index:flat_index + 1]
                 for c in limbs_xyz))
    x, y, inf = E2.to_affine(P)
    return (int(E2.F.from_mont(x)[0]), int(E2.F.from_mont(y)[0]),
            bool(inf.reshape(-1)[0]))


def _same(got, log: int) -> bool:
    want = e2.mul_g(log)
    if want[2] or got[2]:
        return want[2] == got[2]
    return (got[0], got[1]) == (want[0], want[1])


def output_mismatch(outputs, ref, pixels) -> int:
    """Output pixels of either half whose point differs from the
    reference's."""
    bad = 0
    for half, logs in zip(outputs, ref.outputs):
        for p, log in zip(pixels, logs):
            bad += int(not _same(_point(half, p), int(log)))
    return bad


def input_mismatch(ciphertext, ref, pixels) -> int:
    """Input ciphertext pixels (the same flat indices, where they exist)
    whose point differs from the reference's encryption."""
    bad = 0
    for half, logs in zip(ciphertext, ref.ciphertext):
        flat = logs.reshape(-1)
        for p in pixels:
            if p < flat.shape[0]:
                bad += int(not _same(_point(half, p), int(flat[p])))
    return bad


def witness_mismatch(trace, wit: pipeline.Witness, seed: int, req,
                     k: int) -> int:
    """Differences between a recorded trace and the reference's witness:
    each count or scalar that differs, and each of k sampled points
    (drawn from the seed) that differs."""
    fin = trace.finalize() if hasattr(trace, "finalize") else trace
    return witness_mismatch_fin(fin, wit, seed, req, k)


def witness_mismatch_fin(fin, wit: pipeline.Witness, seed: int, req,
                         k: int) -> int:
    bad = 0
    n_m, n_a = len(wit.mult_bases), len(wit.add_left)
    if len(fin["mult_scalars"]) != n_m or len(fin["add_px"]) != n_a:
        return 1 + abs(len(fin["mult_scalars"]) - n_m) + abs(
            len(fin["add_px"]) - n_a)
    bad += sum(int(int(a) != int(b))
               for a, b in zip(fin["mult_scalars"], wit.mult_scalars))
    points = ([("mult", i) for i in range(n_m)] + [("left", i) for i in range(n_a)]
              + [("right", i) for i in range(n_a)])
    for j in inputs.sample(seed, ("witness", req), len(points), k):
        kind, i = points[j]
        if kind == "mult":
            got = (fin["mult_px"][i], fin["mult_py"][i], fin["mult_inf"][i])
            log = wit.mult_bases[i]
        elif kind == "left":
            got = (fin["add_px"][i], fin["add_py"][i], fin["add_p_inf"][i])
            log = wit.add_left[i]
        else:
            got = (fin["add_rx"][i], fin["add_ry"][i], fin["add_r_inf"][i])
            log = wit.add_right[i]
        bad += int(not _same((int(got[0]), int(got[1]), bool(got[2])), log))
    return bad
