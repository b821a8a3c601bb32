"""Fixed-point accuracy harness (reference: src/accuracy/train_test_lenet5.py).

A copy of vpin_tpu/nn/accuracy.py, which is already PyTorch: the port keeps
its own, since importing vpin_tpu.nn runs vpin_tpu/nn/__init__.py, which
imports JAX.

Trains a LeNet-5 in PyTorch (CPU) and compares float inference against
the protocol's fixed-point-with-truncation forward pass (f=16 fractional
bits, truncation bit-widths 35/33/32/33 between layers — reference
forwardFixedPointWithTrunc at :46-64), validating that the quantization
the encrypted protocol performs does not change predictions.

MNIST needs a local copy (this environment has no network egress);
without one, a synthetic separable dataset exercises the same code path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

FRACTION_BITS = 16
TRUNC_BITS = (35, 33, 32, 33)


def _torch():
    import torch
    import torch.nn as nn
    return torch, nn


def build_lenet5():
    torch, nn = _torch()

    class LeNet5(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(1, 6, 5)
            self.pool = nn.AvgPool2d(2, 2)
            self.conv2 = nn.Conv2d(6, 16, 5)
            self.conv3 = nn.Conv2d(16, 120, 5)
            self.fc1 = nn.Linear(120, 84)
            self.fc2 = nn.Linear(84, 10)
            self.relu = nn.ReLU()

        def forward(self, x):
            x = self.pool(self.relu(self.conv1(x)))
            x = self.pool(self.relu(self.conv2(x)))
            x = self.relu(self.conv3(x))
            x = x.flatten(1)
            x = self.relu(self.fc1(x))
            return self.fc2(x)

    return LeNet5()


def forward_fixed_point_with_trunc(model, x, fraction_bits=FRACTION_BITS,
                                   trunc_bits=TRUNC_BITS):
    """Quantized forward replicating the reference exactly
    (train_test_lenet5.py forwardFixedPointWithTrunc + truncation +
    convertModelParametersToFixedPoint): every parameter and the input
    are rounded to f=16 fixed point (held in float tensors, as the
    reference does), activations truncated at 35/33/32/33 bits after
    conv1/conv2/fc(conv3)/fc1 respectively."""
    import copy
    torch, _ = _torch()
    scale = 2.0 ** fraction_bits

    def trunc(t, bits):
        return torch.round(t / (2.0 ** bits) * scale)

    with torch.no_grad():
        m = copy.deepcopy(model)
        for p in m.parameters():
            p.copy_(torch.round(p * scale))
        xq = torch.round(x * scale)

        z = torch.relu(m.conv1(xq))
        z = trunc(z, trunc_bits[0])
        z = m.pool(z)
        z = torch.relu(m.conv2(z))
        z = trunc(z, trunc_bits[1])
        z = m.pool(z)
        z = torch.relu(m.conv3(z))           # == reference fc(400->120)
        z = trunc(z, trunc_bits[2])
        z = z.flatten(1)
        z = torch.relu(m.fc1(z))
        z = trunc(z, trunc_bits[3])
        return m.fc2(z)


def load_mnist_idx(data_dir: str):
    """Raw MNIST idx files (train-images-idx3-ubyte etc.) -> 32x32-padded
    arrays, like the reference's torchvision Resize(32)
    (train_test_lenet5.py:112-113).  Returns None when unavailable."""
    import gzip
    import os

    def read(name, header):
        for n in (name, name + ".gz"):
            p = os.path.join(data_dir, n)
            if os.path.exists(p):
                op = gzip.open if n.endswith(".gz") else open
                with op(p, "rb") as fh:
                    buf = fh.read()
                return np.frombuffer(buf, dtype=np.uint8)[header:]
        return None

    imgs = read("train-images-idx3-ubyte", 16)
    labs = read("train-labels-idx1-ubyte", 8)
    if imgs is None or labs is None:
        return None
    n = len(labs)
    xs = imgs.reshape(n, 28, 28).astype(np.float32) / 255.0
    xs = np.pad(xs, ((0, 0), (2, 2), (2, 2)))[:, None]
    return xs, labs.astype(np.int64)


def synthetic_dataset(n=512, seed=0):
    """32x32 inputs (the reference resizes MNIST 28->32,
    train_test_lenet5.py:112-113)."""
    rng = np.random.RandomState(seed)
    xs = rng.uniform(0, 1, (n, 1, 32, 32)).astype(np.float32)
    ys = np.zeros(n, dtype=np.int64)
    for i in range(n):
        cls = i % 10
        xs[i, 0, cls * 2: cls * 2 + 3, 5:27] += 2.0
        ys[i] = cls
    xs = xs / xs.max()
    return xs, ys


def run_accuracy_eval(data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                      epochs: int = 3, seed: int = 0):
    """Returns (float_acc, fixed_acc, agreement)."""
    torch, nn = _torch()
    torch.manual_seed(seed)

    xs, ys = data if data is not None else synthetic_dataset()
    n_train = int(0.8 * len(xs))
    xtr = torch.tensor(xs[:n_train])
    ytr = torch.tensor(ys[:n_train])
    xte = torch.tensor(xs[n_train:])
    yte = torch.tensor(ys[n_train:])

    model = build_lenet5()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss_fn = nn.CrossEntropyLoss()
    for _ in range(epochs):
        for i in range(0, len(xtr), 64):
            xb, yb = xtr[i:i + 64], ytr[i:i + 64]
            opt.zero_grad()
            loss = loss_fn(model(xb), yb)
            loss.backward()
            opt.step()

    model.eval()
    with torch.no_grad():
        pred_f = model(xte).argmax(1)
        pred_q = forward_fixed_point_with_trunc(model, xte).argmax(1)
    float_acc = float((pred_f == yte).float().mean())
    fixed_acc = float((pred_q == yte).float().mean())
    agreement = float((pred_f == pred_q).float().mean())
    return float_acc, fixed_acc, agreement


if __name__ == "__main__":
    import os
    data = None
    source = "SYNTHETIC separable dataset (no MNIST available; this " \
             "environment has no network egress — results are NOT " \
             "comparable to the reference's MNIST numbers, only the " \
             "quantization pipeline is exercised)"
    mnist_dir = os.environ.get("VPIN_MNIST_DIR")
    if mnist_dir:
        loaded = load_mnist_idx(mnist_dir)
        if loaded is not None:
            n = min(len(loaded[0]), 12_000)
            data = (loaded[0][:n], loaded[1][:n])
            source = f"MNIST idx files from {mnist_dir} ({n} samples); " \
                     "reference E5 trains 10 epochs on the full set"
    epochs = int(os.environ.get("VPIN_ACC_EPOCHS", "10" if data else "3"))
    print(f"dataset: {source}")
    print(f"epochs:  {epochs}")
    fa, qa, ag = run_accuracy_eval(data=data, epochs=epochs)
    print(f"float accuracy:        {fa:.4f}")
    print(f"fixed-point accuracy:  {qa:.4f}")
    print(f"prediction agreement:  {ag:.4f}")
