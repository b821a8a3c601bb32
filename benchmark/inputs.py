"""Everything a run feeds the program, made from ``--seed``: the same seed
gives the same inputs.  Each input has its own stream, named by what it is
for, so that adding an input to a cell leaves the others as they were."""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List

import numpy as np

from .reference.e2 import ORDER


def subseed(seed: int, *parts) -> int:
    """A 64-bit seed for the stream ``parts`` of run ``seed``."""
    text = "/".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little")


def secret_key(seed: int) -> int:
    """The client's ElGamal secret, in [1, q - 2] as the reference draws it."""
    return random.Random(subseed(seed, "key")).randrange(1, ORDER - 1)


def image(seed: int, request: int, size: int) -> np.ndarray:
    """A size x size image of uniform 8-bit values, as float32 (a stand-in
    for an MNIST digit scaled to the size)."""
    rng = np.random.default_rng(subseed(seed, "image", request))
    return rng.integers(0, 256, (size, size)).astype(np.float32)


def nonce_seed(seed: int, request: int) -> int:
    """The seed of the request's random.Random, which draws its ElGamal
    nonces in the reference's order."""
    return subseed(seed, "nonces", request)


def rlc_keys(seed: int, request: int, n: int) -> List[bytes]:
    """The request's n rLC keys (32 bytes each, one a layer half)."""
    rng = random.Random(subseed(seed, "rlc", request))
    return [rng.randbytes(32) for _ in range(n)]


def key_source(keys: List[bytes]):
    """A callable that hands out ``keys`` in order, as the program's
    ``key_source`` is called: one a layer half."""
    it = iter(keys)
    return lambda: next(it)


def weights(fc: List[int], scale: float) -> Dict[str, np.ndarray]:
    """Stand-in FC weights uniform in +-scale, float32, with the shapes of
    the reference's Pre_trained_model files.  One model for every run, as a
    deployment serves one model: the weights set how large the values the
    client decrypts grow, and so its BSGS rounds, so weights drawn from each
    run's seed would change the work from seed to seed."""
    n_in, n_hidden, n_out = fc
    rng = np.random.default_rng(subseed(0, "model weights"))

    def u(*shape):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    return {"weight_fc1": u(n_in, n_hidden), "bias_fc1": u(n_hidden),
            "weight_fc2": u(n_hidden, n_out), "bias_fc2": u(n_out)}


def tape_seed(seed: int, step: int) -> int:
    """The proof's random-tape seed (a u64, as the prover takes it)."""
    return subseed(seed, "tape", step)


def sample(seed: int, what: str, population: int, k: int,
           always=()) -> List[int]:
    """k distinct indices of range(population), drawn from the seed, with
    ``always`` among them."""
    rng = random.Random(subseed(seed, "sample", what))
    pick = set(int(a) for a in always if 0 <= a < population)
    rest = [i for i in range(population) if i not in pick]
    pick.update(rng.sample(rest, max(0, min(k - len(pick), len(rest)))))
    return sorted(pick)
