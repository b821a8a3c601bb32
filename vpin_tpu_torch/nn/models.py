"""The single conv layer workload as an in-process encrypted-inference
pipeline.

Port of vpin_tpu/nn/models.py (the conv workload; CNN A-E and LeNet come
with later slices).  Protocol constants from the reference: filters 3/5/7,
PRF truncation 16 bytes (src/convolution/Server.py:452-469, :86).
"""

from __future__ import annotations

import os
import random
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from ..device import synchronize
from . import fixed_point
from .elgamal import CipherTensor, KeyPair, encrypt_batch
from .homomorphic import HomomorphicEngine
from .prf import fresh_key
from .trace import WitnessTrace

CONV_FILTERS = {
    3: np.array([[1, 0, 1], [2, 0, 2], [1, 0, 1]]),
    5: np.array([[1, 0, 0, 0, 1], [0, 0, 0, 0, 0], [2, 0, 0, 0, 2],
                 [0, 0, 0, 0, 0], [1, 0, 0, 0, 1]]),
    7: np.array([[1, 0, 0, 2, 0, 0, 1]] + [[0] * 7] * 5
                + [[1, 0, 0, 2, 0, 0, 1]]),
}


@dataclass
class WorkloadResult:
    trace: WitnessTrace
    timings: Dict[str, float] = field(default_factory=dict)
    engine: Optional[HomomorphicEngine] = None
    #: True while rLC equality checks are still queued on ``engine``
    #: (run with defer_checks=True); call flush_checks() to settle them.
    checks_pending: bool = False
    #: the encrypted input image and the encrypted conv output
    ciphertext: Optional[CipherTensor] = None
    outputs: Optional[CipherTensor] = None

    def flush_checks(self):
        if self.checks_pending:
            self.engine.flush_checks()
            self.checks_pending = False

    @property
    def num_mults(self):
        if self.checks_pending:
            warnings.warn("WorkloadResult: rLC equality checks were "
                          "deferred and never flushed — call "
                          "flush_checks() to verify the trace",
                          stacklevel=2)
        return self.trace.num_mults

    @property
    def num_adds(self):
        return self.trace.num_adds


def load_reference_image(size: int, base_dir: str = None) -> Optional[np.ndarray]:
    """The reference's MNIST input image for a given size
    (src/convolution/image_mnist_<size>_<size>.npy under ``base_dir`` or
    $VPIN_REFERENCE); None when no directory is given or the file is
    missing."""
    base_dir = base_dir or os.environ.get("VPIN_REFERENCE")
    if not base_dir:
        return None
    path = os.path.join(base_dir, "src", "convolution",
                        f"image_mnist_{size}_{size}.npy")
    try:
        img = np.load(path)
    except (OSError, ValueError):
        return None
    return np.asarray(img, dtype=np.float32).reshape(size, size)


def run_conv_workload(image: np.ndarray, filter_size: int, key: KeyPair,
                      rng: Optional[random.Random] = None,
                      padding: int = 1, stride: int = 1,
                      defer_checks: bool = False,
                      key_source: Callable[[], bytes] = fresh_key
                      ) -> WorkloadResult:
    """Single conv layer on the key's device (reference src/convolution; no
    decryption phase: the client sends the image and exits).

    ``key_source`` gives each ciphertext half's rLC key (os.urandom by
    default).  defer_checks=True waits for the device to finish but fetches
    nothing: the rLC equality checks stay queued on ``result.engine`` until
    ``result.flush_checks()``."""
    rng = rng or random.Random()
    dev = key.device
    t0 = time.perf_counter()
    scaled = fixed_point.min_max_scaling(image)
    fixed = fixed_point.encode(scaled)
    ct = encrypt_batch(fixed, key, rng)
    synchronize(dev)
    t1 = time.perf_counter()

    eng = HomomorphicEngine(prf_trunc_bytes=16)
    filt = CONV_FILTERS[filter_size]
    outs = [eng.conv2d(half, filt, key=key_source(), padding=padding,
                       stride=stride) for half in ct]
    if defer_checks:
        synchronize(dev)
    else:
        eng.flush_checks()
    t2 = time.perf_counter()
    return WorkloadResult(eng.trace,
                          timings={"encrypt": t1 - t0, "inference": t2 - t1},
                          engine=eng, checks_pending=bool(defer_checks),
                          ciphertext=ct, outputs=CipherTensor(*outs))
