"""The vPIN model zoo as in-process encrypted-inference pipelines.

Port of vpin_tpu/nn/models.py.  Protocol constants from the reference:
  * single conv layer — filters 3/5/7, PRF truncation 16 bytes
                        (src/convolution/Server.py:452-469, :86)
  * CNN A-E           — conv3x3 (pad 1) -> ReLU -> avgpool -> FC1 -> ReLU
                        (shift) -> FC2, PRF truncation 14 bytes
                        (src/cnn_networks/Server.py:34-76, :724-772)
  * LeNet-5           — 5x5 convs with the classic sparse connection table,
                        PRF truncation 13 bytes (src/LeNet/Server.py)

The client's steps (BSGS decryption, ReLU, fixed-point shifts) follow the
reference client's float32 semantics exactly (cnn_networks/Client.py
:273-276, :308-321; LeNet/Client.py:322-368).  Every pipeline runs on the
key's device.
"""

from __future__ import annotations

import os
import random
import time
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..curve.weierstrass import PointW
from ..device import synchronize
from ..field.limbs import N_LIMBS
from . import fixed_point
from .bsgs import BsgsTable
from .elgamal import CipherTensor, KeyPair, decrypt_batch, encrypt_batch
from .homomorphic import HomomorphicEngine, channel_sum
from .prf import fresh_key
from .trace import WitnessTrace

CONV_FILTERS = {
    3: np.array([[1, 0, 1], [2, 0, 2], [1, 0, 1]]),
    5: np.array([[1, 0, 0, 0, 1], [0, 0, 0, 0, 0], [2, 0, 0, 0, 2],
                 [0, 0, 0, 0, 0], [1, 0, 0, 0, 1]]),
    7: np.array([[1, 0, 0, 2, 0, 0, 1]] + [[0] * 7] * 5
                + [[1, 0, 0, 2, 0, 0, 1]]),
}

LENET_FILTER = np.array([[2, 0, 0, 0, 0], [0, 2, 0, 0, 0], [0, 0, 1, 0, 0],
                         [0, 0, 0, 2, 0], [0, 0, 0, 0, 2]])

LENET_CONNECTION_TABLE = [
    [1, 1, 1, 0, 0, 0], [0, 1, 1, 1, 0, 0], [0, 0, 1, 1, 1, 0],
    [0, 0, 0, 1, 1, 1], [1, 0, 0, 0, 1, 1], [1, 1, 0, 0, 0, 1],
    [1, 1, 1, 1, 0, 0], [0, 1, 1, 1, 1, 0], [0, 0, 1, 1, 1, 1],
    [1, 0, 0, 1, 1, 1], [1, 1, 0, 0, 1, 1], [1, 1, 1, 0, 0, 1],
    [1, 1, 0, 1, 1, 0], [0, 1, 1, 0, 1, 1], [1, 0, 1, 1, 0, 1],
    [1, 1, 1, 1, 1, 1],
]

# CNN A-E: (fc1_in, fc1_out, pool_kernel, pool_stride)
CNN_CONFIGS = {
    "A": (64, 16, 4, 4),
    "B": (64, 32, 4, 4),
    "C": (256, 16, 2, 2),
    "D": (256, 32, 2, 2),
    "E": (256, 64, 2, 2),
}

#: where vpin_tpu looks for the reference checkout when $VPIN_REFERENCE is
#: unset (vpin_tpu/nn/models.py:100, :131); the port takes the same default
DEFAULT_REFERENCE_DIR = "/root/reference"


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
    #: the decrypted, ReLU'd logits (CNN and LeNet)
    logits: Optional[np.ndarray] = None
    #: LeNet's per-layer (mult_range, add_range) witness slices, L1..L7
    layer_slices: Optional[Dict[str, tuple]] = None
    #: giant-step rounds of each decryption, in order
    decrypt_rounds: List[int] = field(default_factory=list)

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


def _reference_dir(base_dir: Optional[str]) -> str:
    return base_dir or os.environ.get("VPIN_REFERENCE", DEFAULT_REFERENCE_DIR)


def load_reference_image(size: int, base_dir: str = None) -> Optional[np.ndarray]:
    """The reference's MNIST input image for a given size
    (src/convolution/image_mnist_<size>_<size>.npy under ``base_dir``,
    $VPIN_REFERENCE or DEFAULT_REFERENCE_DIR); None when it is missing."""
    path = os.path.join(_reference_dir(base_dir), "src", "convolution",
                        f"image_mnist_{size}_{size}.npy")
    try:
        img = np.load(path)
    except (OSError, ValueError):
        return None
    return np.asarray(img, dtype=np.float32).reshape(size, size)


def make_random_weights(fc1_in: int, fc1_out: int, fc2_out: int = 10,
                        seed: int = 0, scale: float = 0.5
                        ) -> Dict[str, np.ndarray]:
    """Stand-in pretrained weights, uniform in +-``scale`` from ``seed``
    (the default: the shapes and scale of the .npy files under
    Pre_trained_model/)."""
    rng = np.random.RandomState(seed)
    return {
        "weight_fc1": rng.uniform(-scale, scale, (fc1_in, fc1_out)).astype(np.float32),
        "bias_fc1": rng.uniform(-scale, scale, (fc1_out,)).astype(np.float32),
        "weight_fc2": rng.uniform(-scale, scale, (fc1_out, fc2_out)).astype(np.float32),
        "bias_fc2": rng.uniform(-scale, scale, (fc2_out,)).astype(np.float32),
    }


def load_pretrained_weights(version: str = None, lenet: bool = False,
                            base_dir: str = None) -> Optional[Dict]:
    """The reference's pretrained .npy weights (MODEL_PATHS,
    src/cnn_networks/Server.py:34-60 and LeNet/Server.py:867-870) under
    ``base_dir``, $VPIN_REFERENCE or DEFAULT_REFERENCE_DIR; None when the
    files are missing (callers then take make_random_weights)."""
    base_dir = _reference_dir(base_dir)
    if lenet:
        d = os.path.join(base_dir, "src", "LeNet", "Pre_trained_model")
        names = {"weight_fc1": "weight_fc1_120_84.npy",
                 "bias_fc1": "bias_fc1_84.npy",
                 "weight_fc2": "weight_fc2_84_10.npy",
                 "bias_fc2": "bias_fc2_10.npy"}
    else:
        fc1_in, fc1_out, _, _ = CNN_CONFIGS[version]
        d = os.path.join(base_dir, "src", "cnn_networks", "Pre_trained_model")
        names = {"weight_fc1": f"weight_fc1_{fc1_in}_{fc1_out}.npy",
                 "bias_fc1": f"bias_fc1_{fc1_out}.npy",
                 "weight_fc2": f"weight_fc2_{fc1_out}_10.npy",
                 "bias_fc2": "bias_fc2_10.npy"}
    try:
        return {k: np.load(os.path.join(d, v)) for k, v in names.items()}
    except (OSError, ValueError):
        return None


class _Clock:
    """Host time per stage of a pipeline when ``timed``: each stage then
    ends in a device synchronize, so the device's work is charged to the
    stage that queued it.  Untimed, it records nothing and never waits on
    the device."""

    def __init__(self, device: torch.device, timed: bool):
        self.device, self.timed = device, timed
        self.times: Dict[str, float] = {}

    @contextmanager
    def __call__(self, stage: str):
        if not self.timed:
            yield
            return
        t = time.perf_counter()
        yield
        synchronize(self.device)
        self.times[stage] = self.times.get(stage, 0.0) + time.perf_counter() - t


class _Client:
    """The client's half of a pipeline: decryptions, ReLU, shifts and
    re-encryptions, with their rounds and times."""

    def __init__(self, key: KeyPair, table: BsgsTable, rng: random.Random,
                 clock: _Clock, max_steps=None):
        self.key, self.table, self.rng = key, table, rng
        self.clock, self.max_steps = clock, max_steps
        self.rounds: List[int] = []

    def decrypt(self, ct: CipherTensor) -> np.ndarray:
        with self.clock("decrypt"):
            vals = decrypt_batch(ct, self.key, self.table,
                                 max_steps=self.max_steps)
        self.rounds.append(self.table.last_rounds)
        return np.asarray(vals.tolist(), dtype=np.int64)

    def encrypt(self, values) -> CipherTensor:
        with self.clock("encrypt"):
            return encrypt_batch(values, self.key, self.rng)

    def interact(self, ct: CipherTensor, relu: bool,
                 shift_bits: Optional[int]) -> CipherTensor:
        """One client round trip (the reference's _interact): decrypt, ReLU
        and/or shift, re-encrypt."""
        out = self.decrypt(ct)
        if relu:
            out = np.maximum(0, out)
        if shift_bits is not None:
            out = fixed_point.shift(out, shift_bits)
        return self.encrypt(out)


def _fc_weights(weights: Dict, layer: str, client: _Client):
    """(encoded integer weights, encrypted encoded bias) of FC ``layer``."""
    w = fixed_point.encode(weights[f"weight_{layer}"]).astype(object)
    bias = client.encrypt(fixed_point.encode(weights[f"bias_{layer}"]))
    return w, bias


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


def run_cnn_workload(version: str, image: np.ndarray, key: KeyPair,
                     table: BsgsTable, weights: Optional[Dict] = None,
                     rng: Optional[random.Random] = None,
                     max_steps=None,
                     key_source: Callable[[], bytes] = fresh_key,
                     timed: bool = False) -> WorkloadResult:
    """CNN A-E on the key's device (reference src/cnn_networks/Server.py
    inferenceCNN).  ``key_source`` gives each layer half's rLC key.
    Timings (s): total; with ``timed`` (a device synchronize at the end of
    each stage) also encrypt (every client encryption), conv, pool, fc (the
    server's layers, rLC work included) and decrypt (the four
    decryptions)."""
    rng = rng or random.Random()
    fc1_in, fc1_out, k, s = CNN_CONFIGS[version]
    weights = (weights or load_pretrained_weights(version)
               or make_random_weights(fc1_in, fc1_out))
    clock = _Clock(key.device, timed)
    client = _Client(key, table, rng, clock, max_steps)
    t0 = time.perf_counter()

    ct = client.encrypt(fixed_point.encode(fixed_point.min_max_scaling(image)))
    eng = HomomorphicEngine(prf_trunc_bytes=14)

    with clock("conv"):
        conv = CipherTensor(*(eng.conv2d(h, CONV_FILTERS[3], key=key_source(),
                                         padding=1, stride=1) for h in ct))
    ct = client.interact(conv, relu=True, shift_bits=None)

    with clock("pool"):
        pooled = CipherTensor(*(eng.avgpool2d(h, k, s) for h in ct))
        flat = CipherTensor(*(PointW(*(c.reshape(-1, N_LIMBS) for c in h))
                              for h in pooled))
    ct = client.interact(flat, relu=False, shift_bits=26)

    w1, bias1 = _fc_weights(weights, "fc1", client)
    with clock("fc"):
        fc1 = CipherTensor(*(eng.fc(h, w1, bias1[i], key=key_source())
                             for i, h in enumerate(ct)))
    ct = client.interact(fc1, relu=True, shift_bits=32)

    w2, bias2 = _fc_weights(weights, "fc2", client)
    with clock("fc"):
        fc2 = CipherTensor(*(eng.fc(h, w2, bias2[i], key=key_source())
                             for i, h in enumerate(ct)))

    logits = np.maximum(0, client.decrypt(fc2))
    eng.flush_checks()
    timings = dict(clock.times, total=time.perf_counter() - t0)
    return WorkloadResult(eng.trace, timings=timings, engine=eng,
                          logits=logits, decrypt_rounds=client.rounds)


def run_lenet_workload(image: np.ndarray, key: KeyPair, table: BsgsTable,
                       weights: Optional[Dict] = None,
                       rng: Optional[random.Random] = None,
                       num_kernels=(6, 16, 120), pool=(2, 2),
                       max_steps=None,
                       key_source: Callable[[], bytes] = fresh_key,
                       timed: bool = False) -> WorkloadResult:
    """LeNet-5 on the key's device (reference src/LeNet/Server.py
    inferenceCNN): per-kernel conv/interaction loops, the sparse connection
    table, per-layer witness slices L1..L7.  ``key_source`` gives each
    layer half's rLC key; ``timed`` adds stage times to the total, as in
    run_cnn_workload."""
    rng = rng or random.Random()
    weights = (weights or load_pretrained_weights(lenet=True)
               or make_random_weights(120, 84))
    nk1, nk2, nk3 = num_kernels
    k, s = pool
    clock = _Clock(key.device, timed)
    client = _Client(key, table, rng, clock, max_steps)
    t0 = time.perf_counter()

    ct0 = client.encrypt(fixed_point.encode(fixed_point.min_max_scaling(image)))
    eng = HomomorphicEngine(prf_trunc_bytes=13)
    marks = {}

    def mark(name):
        marks[name] = (eng.trace.num_mults, eng.trace.num_adds)

    def conv(halves):
        with clock("conv"):
            return CipherTensor(*(eng.conv2d(h, LENET_FILTER, key=key_source())
                                  for h in halves))

    def pool_layer(c):
        with clock("pool"):
            return CipherTensor(*(eng.avgpool2d(h, k, s) for h in c))

    def summed(chans):
        with clock("conv"):
            return CipherTensor(channel_sum([c.c1 for c in chans]),
                                channel_sum([c.c2 for c in chans]))

    # L1: conv1 (6 kernels, the same hard-coded filter, pad 0)
    conv1 = [conv(ct0) for _ in range(nk1)]
    mark("L1")
    act1 = [client.interact(c, relu=True, shift_bits=None) for c in conv1]

    # L2: pool1 + shift 26
    pool1 = [pool_layer(c) for c in act1]
    mark("L2")
    act2 = [client.interact(c, relu=False, shift_bits=26) for c in pool1]

    # L3: conv2 (16 kernels over connection-table channel sums)
    conv2 = [conv(summed([act2[j] for j in range(nk1) if row[j]]))
             for row in LENET_CONNECTION_TABLE[:nk2]]
    mark("L3")
    act3 = [client.interact(c, relu=True, shift_bits=None) for c in conv2]

    # L4: pool2 + shift 26
    pool2 = [pool_layer(c) for c in act3]
    mark("L4")
    act4 = [client.interact(c, relu=False, shift_bits=26) for c in pool2]

    # L5: conv3 (120 kernels over the sum of all 16 channels)
    total = summed(act4)
    conv3 = [conv(total) for _ in range(nk3)]
    mark("L5")

    # flatten the 120 single-pixel outputs into a vector, ReLU + shift 26
    vec = CipherTensor(_stack_outputs([c.c1 for c in conv3]),
                       _stack_outputs([c.c2 for c in conv3]))
    ct = client.interact(vec, relu=True, shift_bits=26)

    # L6: FC1 120->84, then ReLU + shift 33
    w1, bias1 = _fc_weights(weights, "fc1", client)
    with clock("fc"):
        fc1 = CipherTensor(*(eng.fc(h, w1, bias1[i], key=key_source())
                             for i, h in enumerate(ct)))
    mark("L6")
    ct = client.interact(fc1, relu=True, shift_bits=33)

    # L7: FC2 84->10
    w2, bias2 = _fc_weights(weights, "fc2", client)
    with clock("fc"):
        fc2 = CipherTensor(*(eng.fc(h, w2, bias2[i], key=key_source())
                             for i, h in enumerate(ct)))
    mark("L7")

    logits = np.maximum(0, client.decrypt(fc2))
    eng.flush_checks()

    # layer slices (mult_range, add_range) in the reference's L1..L7 order
    slices = {}
    prev = (0, 0)
    for name in ["L1", "L2", "L3", "L4", "L5", "L6", "L7"]:
        cur = marks[name]
        slices[name] = ((prev[0], cur[0]), (prev[1], cur[1]))
        prev = cur
    timings = dict(clock.times, total=time.perf_counter() - t0)
    return WorkloadResult(eng.trace, timings=timings, engine=eng,
                          logits=logits, layer_slices=slices,
                          decrypt_rounds=client.rounds)


def _stack_outputs(halves: List[PointW]) -> PointW:
    """Stack a list of (1, 1)-shaped conv outputs into an (n,) vector."""
    return PointW(*(torch.stack([h[i].reshape(N_LIMBS) for h in halves])
                    for i in range(3)))
