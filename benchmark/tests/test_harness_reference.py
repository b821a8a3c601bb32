"""The plain reference against vpin_tpu_torch on the CPU at small sizes:
the group arithmetic, the single conv, CNN A at 8x8 with a small table, and
the 2-add and 2-mult proofs of a conv witness."""

from __future__ import annotations

import random

import pytest

from benchmark import inputs
from benchmark.reference import e2
from benchmark.tests.small import run_small


def test_group_constants_and_mul_g():
    from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER, E2_P
    assert (e2.P, e2.ORDER) == (E2_P, E2_ORDER)
    rng = random.Random(3)
    for a in [0, 1, 2, 255, 256, e2.ORDER - 1] + [rng.randrange(e2.ORDER)
                                                  for _ in range(20)]:
        want = a * E2_G_HOST
        got = e2.mul_g(a)
        assert got == ((0, 0, True) if want.inf else (want.x, want.y, False))
        assert got[2] or e2.on_curve(got[0], got[1])


def test_conv_matches_the_port():
    """Every output pixel, every input pixel and every witness point of a
    5x5 request agree (the corner sample then covers the whole output)."""
    from benchmark import cells
    from benchmark.drivers import serve
    from benchmark.reference import pipeline
    from vpin_tpu_torch.nn.elgamal import KeyPair
    from vpin_tpu_torch.nn.models import run_conv_workload
    cfg = cells.config(cells.benchmark(), "conv3")
    seed, size = 2 ** 33 + 1, 5
    x = inputs.secret_key(seed)
    keys = inputs.rlc_keys(seed, 0, 2)
    res = run_conv_workload(inputs.image(seed, 0, size), 3,
                            KeyPair.from_secret(x, device="cpu"),
                            random.Random(inputs.nonce_seed(seed, 0)),
                            key_source=inputs.key_source(keys))
    pixels = list(range(size * size))
    ref = pipeline.conv_request(cfg, inputs.image(seed, 0, size), x,
                                inputs.nonce_seed(seed, 0),
                                inputs.key_source(keys), pixels=pixels)
    assert serve.output_mismatch(res.outputs, ref, pixels) == 0
    assert serve.input_mismatch(res.ciphertext, ref, pixels) == 0
    fin = res.trace.finalize()
    n = len(fin["mult_scalars"]) + 2 * len(fin["add_px"])
    assert serve.witness_mismatch_fin(fin, ref.witness, seed, 0, n) == 0


def test_cnn_a_8x8_matches_the_port(bench):
    """CNN A on an 8x8 image (pool 4x4 into 4 FC1 inputs), table m = 2^15:
    the logits and the sampled witness points equal the reference's."""
    line = run_small(bench, "cnn_a.serve_32", size=8, check_points=64,
                     config=_cnn8(bench))
    assert line["correct"], line["checks"]
    assert line["checks"]["logits_mismatch"]["value"] == 0


def _cnn8(bench):
    from benchmark.tests.small import small
    cfg, _ = small(bench, "cnn_a.serve_32")
    cfg["fc"] = [4, 16, 10]
    return cfg


def test_two_add_proof(bench):
    """The 2-add proof with the eval proof: the witness handed over and the
    commitments it was verified against equal the reference's, the proof
    verifies, and its size is the golden fixture's."""
    line = run_small(bench, "conv3.prove_add")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


def test_two_mult_proof(bench):
    """The 2-mult, 128-bit transparent proof: the witness handed over and
    the commitments it was verified against equal the reference's, the
    proof verifies, and its size is the golden fixture's."""
    line = run_small(bench, "conv3.prove_mult")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


def test_a_gadget_the_reference_cannot_commit(bench):
    """A proof mix whose gadget has no layout under reference/gadgets/
    does not run: nothing would tie its proofs to a witness."""
    with pytest.raises(ModuleNotFoundError):
        run_small(bench, "conv3.prove_add", gadget="pairing")
