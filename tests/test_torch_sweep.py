"""The reference's other configurations on the port (vpin_tpu_torch on the
CPU: plain PyTorch versions of K1-K3): the single-conv sweep's filters 5 and
7 (E3) and the pool-2 geometry of CNN C-E.

Tolerance: exact.  The conv cases hold the port against the exact host
arithmetic of curve/host_ec.py: trace counts 2 f^2 / 2 (f^2 - 1), the rLC
check, the whole finalized witness and every output pixel.  The trace
depends only on f, so the smallest images with more than one output pixel
stand in for the sweep's 32-256 (tests/test_torch_conv.py holds the same
cases against vpin_tpu in its slow tier).  The CNN cases hold the client's
logits against a plaintext integer pipeline of the same fixed-point steps,
and the full-width stand-in pipelines' decrypted values against the BSGS
table's range.  The proof sizes chip_smoke.py requires of the sweep's
proofs (utils/bincode.snark_size, from an instance's shape) are held against
the sizes vpin_tpu recorded and against a serialized proof.
"""

import json
import random

import numpy as np
import pytest
import torch

from vpin_tpu_torch.curve.weierstrass import E2
from vpin_tpu_torch.gadgets import point_addition, point_mult
from vpin_tpu_torch.nn import CNN_CONFIGS, CONV_FILTERS, KeyPair
from vpin_tpu_torch.nn.host_check import (
    check_conv_outputs, check_conv_trace, cnn_plain_decrypts, cnn_plain_logits,
)
from vpin_tpu_torch.nn.models import make_random_weights, run_conv_workload
from vpin_tpu_torch.runner import cli
from vpin_tpu_torch.utils.bincode import snark_size

from test_torch_models import host_cache

# (filter, image size): 3x3 and 2x2 output pixels
SWEEP_CASES = [(5, 5), (7, 6)]
RLC_KEYS = (b"\x05" * 32, b"\x06" * 32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=SWEEP_CASES,
                ids=[f"f{f}" for f, _ in SWEEP_CASES])
def conv(request):
    f, size = request.param
    key = KeyPair.generate(random.Random(3), device="cpu")
    img = np.random.RandomState(f).uniform(0.0, 1.0, (size, size)).astype(
        np.float32)
    keys = iter(RLC_KEYS)
    res = run_conv_workload(img, f, key, random.Random(4),
                            key_source=lambda: next(keys))
    return f, size, res, res.trace.finalize()


def test_conv_counts_and_rlc_check(conv):
    f, size, res, fin = conv
    assert not res.checks_pending               # flushed: the rLC check held
    assert res.num_mults == 2 * f * f and res.num_adds == 2 * (f * f - 1)
    assert fin["mult_scalars"] == [int(w) for w in
                                   CONV_FILTERS[f].reshape(-1)] * 2
    out = size + 3 - f
    assert res.outputs.c1.batch_shape == (out, out)


def test_conv_trace_is_consistent_on_the_host(conv):
    f, _, _, fin = conv
    check_conv_trace(fin, CONV_FILTERS[f])


def test_conv_every_output_pixel_matches_host(conv):
    f, size, res, _ = conv
    out = size + 3 - f
    for half_in, half_out in zip(res.ciphertext, res.outputs):
        check_conv_outputs(E2.to_affine_host(half_in),
                           E2.to_affine_host(half_out), CONV_FILTERS[f],
                           list(range(out * out)))


def test_cli_conv_filter_7_export(tmp_path, capsys):
    assert cli.main(["conv", "--filter", "7", "--size", "6", "--seed", "2",
                     "--device", "cpu", "--export", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "multiplications: 98" in out and "additions: 96" in out
    wflat = CONV_FILTERS[7].reshape(-1)
    mdir, adir = tmp_path / "pointMult", tmp_path / "pointAdd"
    weights = json.loads((mdir / "weight.json").read_text())
    assert weights == [str(w) for w in wflat] * 2
    px = json.loads((mdir / "point_mult_px_byte.json").read_text())
    assert len(px) == 98 and all(len(row) == 32 for row in px)
    rz = json.loads((adir / "point_add_rz_byte.json").read_text())
    # the temps of the filter's 43 zero weights are the identity
    assert rz == [1 if w == 0 else 0 for w in wflat[1:]] * 2
    assert sum(rz) == 2 * 43


def test_cli_cnn_c_on_cpu(tmp_path, capsys):
    """CNN C on a 4x4 image: pool 2x2 into 4 FC1 inputs, FC1 4 -> 16, weights
    of scale 1e-3, the table from a cache at m = 2^18 and 2,048 giant steps,
    as test_torch_models.test_cli_cnn_on_cpu runs A."""
    cache = tmp_path / "t.pkl"
    host_cache(cache, 1 << 18)
    assert cli.main(["cnn", "--version", "C", "--size", "4", "--seed", "1",
                     "--device", "cpu", "--bsgs-m", str(1 << 18),
                     "--bsgs-cache", str(cache), "--weight-scale", "1e-3",
                     "--max-steps", "2048"]) == 0
    out = capsys.readouterr().out
    # conv 2 x (9, 8); pool 2 x 4 x 3 adds; FC1 4 -> 16: 2 x (4, 16 + 3);
    # FC2 16 -> 10: 2 x (16, 10 + 15)
    assert "multiplications: 58" in out and "additions: 128" in out
    logits = json.loads(out.split("Logits: ")[1].splitlines()[0])
    img = cli._make_image(4, 1)
    weights = make_random_weights(4, 16, seed=1, scale=1e-3)
    want = cnn_plain_logits(img, weights, "C")
    assert logits == want.tolist() and any(logits)


@pytest.mark.parametrize("version", list(CNN_CONFIGS))
def test_stand_in_cnn_decrypts_in_range(version):
    """Every value the client decrypts in a 32x32 request with the seed-0
    stand-in weights (uniform in +-0.5, chip_smoke.py's) lies within the
    +-m^2/2 that m = 3,200,000 baby steps and m giant steps reach."""
    fc1_in, fc1_out, _, _ = CNN_CONFIGS[version]
    img = np.random.RandomState(0).uniform(0.0, 1.0, (32, 32)).astype(
        np.float32)
    values = cnn_plain_decrypts(img, make_random_weights(fc1_in, fc1_out,
                                                         seed=0), version)
    assert [v.size for v in values] == [1024, fc1_in, fc1_out, 10]
    m = 3_200_000
    assert all(int(np.abs(v).max()) < m * m // 2 for v in values)


def instance_size(kind: str, count: int, full: bool) -> int:
    """utils/bincode.snark_size of the instance of ``count`` point adds or
    128-bit point mults."""
    A, B, C, nc, nv, *_ = (point_addition.build_matrices(count)
                           if kind == "add"
                           else point_mult.build_matrices(count, 128))
    return snark_size(nc, nv, max(len(A[0]), len(B[0]), len(C[0])), full)


# proof sizes vpin_tpu recorded: BENCH_r05.json (conv3/32x32's 16-add full
# SNARK and 18-mult transparent proof) and artifacts/LENET_PROOFS.md (L7's
# 186 adds and 168 mults, full SNARK, together)
@pytest.mark.parametrize("parts,size", [
    ((("add", 16, True),), 27240),
    ((("mult", 18, False),), 19920),
    ((("add", 186, True), ("mult", 168, True)), 227976),
], ids=["conv3_adds_full", "conv3_mults", "lenet_L7_full"])
def test_snark_size_matches_vpin_tpu_records(parts, size):
    assert sum(instance_size(*p) for p in parts) == size


def test_snark_size_equals_a_serialized_proof():
    from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER
    from vpin_tpu_torch.runner import proof_runner
    rng = random.Random(5)
    P = [rng.randrange(1, E2_ORDER) * E2_G_HOST for _ in range(6)]
    st = proof_runner.prove_point_add(
        [p.x for p in P[:3]], [p.y for p in P[:3]], [p.x for p in P[3:]],
        [p.y for p in P[3:]], [0] * 3, tape_seed=1, quiet=True,
        device="cpu", full_snark=False)
    assert st.size_bytes == instance_size("add", 3, False)
