"""The port's encrypted conv slice (vpin_tpu_torch on the CPU: plain PyTorch
versions of K1-K3) end to end: ElGamal encryption, the homomorphic conv with
its rLC check, the witness trace and its export.

Tolerance: exact.  The fast tier holds the slice against the exact host
arithmetic of curve/host_ec.py, the oracle vpin_tpu's own tests use.  The
slow tier runs vpin_tpu's run_conv_workload on the same seeds and rLC keys
and requires equal finalized traces, byte-equal JSON exports and equal conv
outputs in affine form.
"""

import json
import random

import numpy as np
import pytest
import torch

from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER
from vpin_tpu_torch.curve.weierstrass import E2
from vpin_tpu_torch.nn import (
    CONV_FILTERS, HomomorphicEngine, KeyPair, RLCCheckError, encrypt_batch,
    run_conv_workload,
)
from vpin_tpu_torch.nn import fixed_point
from vpin_tpu_torch.nn.homomorphic import _window_indices
from vpin_tpu_torch.nn.host_check import (
    HostCheckError, check_conv_outputs, check_conv_trace, corner_pixels,
)
from vpin_tpu_torch.runner import cli

FILT = CONV_FILTERS[3]
RLC_KEYS = (b"\x01" * 32, b"\x02" * 32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixed_keys():
    keys = iter(RLC_KEYS)
    return lambda: next(keys)


def image(size, seed=0):
    return np.random.RandomState(seed).uniform(0.0, 1.0, (size, size)).astype(
        np.float32)


@pytest.fixture(scope="module")
def run():
    key = KeyPair.generate(random.Random(3), device="cpu")
    res = run_conv_workload(image(3), 3, key, random.Random(4),
                            key_source=fixed_keys())
    return key, res, res.trace.finalize()


def test_counts_and_rlc_check(run):
    _, res, fin = run
    assert not res.checks_pending
    assert res.num_mults == 18 and res.num_adds == 16
    assert fin["mult_scalars"] == [int(w) for w in FILT.reshape(-1)] * 2
    assert res.outputs.c1.batch_shape == (3, 3)


def test_every_output_pixel_matches_host(run):
    _, res, _ = run
    for half_in, half_out in zip(res.ciphertext, res.outputs):
        check_conv_outputs(E2.to_affine_host(half_in),
                           E2.to_affine_host(half_out), FILT, list(range(9)))


def test_trace_is_consistent_on_the_host(run):
    _, _, fin = run
    check_conv_trace(fin, FILT)
    broken = dict(fin, add_px=np.roll(fin["add_px"], 1))
    with pytest.raises(HostCheckError):
        check_conv_trace(broken, FILT)


def test_encryption_matches_host(run):
    key, res, _ = run
    msgs = fixed_point.encode(fixed_point.min_max_scaling(image(3)))
    draws = random.Random(4)
    rs = [draws.randrange(1, E2_ORDER - 1) for _ in range(msgs.size)]
    c1 = E2.to_affine_host(res.ciphertext.c1).reshape(-1)
    c2 = E2.to_affine_host(res.ciphertext.c2).reshape(-1)
    for i, (m, r) in enumerate(zip(msgs.reshape(-1), rs)):
        assert c1[i] == r * E2_G_HOST
        assert c2[i] == int(m) * E2_G_HOST + r * key.h_host


def test_encrypt_negative_messages(run):
    key, _, _ = run
    msgs = [[0, -1], [5, -70000]]
    draws = random.Random(9)
    rs = [draws.randrange(1, E2_ORDER - 1) for _ in range(4)]
    ct = encrypt_batch(msgs, key, random.Random(9))
    c2 = E2.to_affine_host(ct.c2).reshape(-1)
    for got, m, r in zip(c2, sum(msgs, []), rs):
        assert got == m * E2_G_HOST + r * key.h_host


def test_rlc_mismatch_raises():
    eng = HomomorphicEngine()
    eng.pending_checks = [torch.tensor(True), torch.tensor(False)]
    with pytest.raises(RLCCheckError):
        eng.flush_checks()
    assert eng.pending_checks == []


def test_export_json(run, tmp_path):
    _, res, fin = run
    res.trace.export_json(str(tmp_path / "T"), _finalized=fin)
    mdir, adir = tmp_path / "T" / "pointMult", tmp_path / "T" / "pointAdd"
    weights = json.loads((mdir / "weight.json").read_text())
    assert weights == [str(w) for w in FILT.reshape(-1)] * 2
    px = json.loads((mdir / "point_mult_px_byte.json").read_text())
    assert len(px) == 18 and all(len(row) == 32 for row in px)
    assert px[0] == list(int(fin["mult_px"][0]).to_bytes(32, "little"))
    rz = json.loads((adir / "point_add_rz_byte.json").read_text())
    # temps of weight 0 are the identity
    assert rz == [1 if w == 0 else 0 for w in FILT.reshape(-1)[1:]] * 2


@pytest.mark.parametrize("H,W,f,padding,stride",
                         [(3, 3, 3, 1, 1), (4, 5, 3, 0, 1), (6, 6, 5, 2, 2)])
def test_window_indices_match_jax(H, W, f, padding, stride):
    from vpin_tpu.nn.homomorphic import _window_indices as jax_windows
    got = _window_indices(H, W, f, padding, stride)
    want = jax_windows(H, W, f, padding, stride)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def test_corner_pixels():
    px = corner_pixels(32, 32, 8, seed=1)
    assert len(px) == 8 and len(set(px)) == 8
    assert {0, 31, 992, 1023} <= set(px)


def test_cli_conv_on_cpu(tmp_path, capsys, monkeypatch):
    # --prove hands the recorded trace to the full-SNARK prover (its proofs
    # are held against vpin_tpu in test_torch_snark.py and
    # test_torch_spark.py; here only the hand-over is checked)
    from vpin_tpu_torch.runner import proof_runner
    proved = []
    monkeypatch.setattr(proof_runner, "prove_trace",
                        lambda trace, **kw: proved.append((trace, kw)))
    assert cli.main(["conv", "--size", "2", "--seed", "1", "--device", "cpu",
                     "--export", str(tmp_path / "out"), "--prove"]) == 0
    out = capsys.readouterr().out
    assert "multiplications: 18" in out and "additions: 16" in out
    rz = json.loads((tmp_path / "out" / "pointAdd" / "point_add_rz_byte.json")
                    .read_text())
    assert len(rz) == 16
    (trace, kw), = proved
    assert trace.num_mults == 18 and trace.num_adds == 16
    assert kw["full_snark"] and kw["tape_seed"] == 1


# ----------------------------------------------------------------------
# slow tier: the same slice through vpin_tpu
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """One 2x2 conv request through vpin_tpu and through the port, with the
    same key pair, nonce seed and rLC keys; vpin_tpu's inputs and outputs
    are captured by wrapping its encrypt_batch and conv2d."""
    from vpin_tpu.nn import models as jmodels
    from vpin_tpu.nn.elgamal import KeyPair as JKeyPair
    from vpin_tpu_torch import convert

    captured = {"outs": []}

    class Engine(jmodels.HomomorphicEngine):
        def conv2d(self, *args, **kwargs):
            out = super().conv2d(*args, **kwargs)
            captured["outs"].append(out)
            return out

    real_encrypt = jmodels.encrypt_batch

    def encrypt(*args, **kwargs):
        captured["ct"] = real_encrypt(*args, **kwargs)
        return captured["ct"]

    jkey = JKeyPair.generate(random.Random(5))
    keys = fixed_keys()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "fresh_key", keys)
        mp.setattr(jmodels, "HomomorphicEngine", Engine)
        mp.setattr(jmodels, "encrypt_batch", encrypt)
        jres = jmodels.run_conv_workload(image(2, 1), 3, jkey, random.Random(6))
    jdir = tmp_path_factory.mktemp("jax")
    jfin = jres.trace.finalize()
    jres.trace.export_json(str(jdir), _finalized=jfin)

    key = convert.keypair_from_jax(jkey, "cpu")
    res = run_conv_workload(image(2, 1), 3, key, random.Random(6),
                            key_source=fixed_keys())
    pdir = tmp_path_factory.mktemp("port")
    fin = res.trace.finalize()
    res.trace.export_json(str(pdir), _finalized=fin)
    return dict(jres=jres, jfin=jfin, jdir=jdir, jct=captured["ct"],
                jouts=captured["outs"], res=res, fin=fin, pdir=pdir)


def _affine(pts):
    return [(p.inf, int(p.x), int(p.y)) for p in
            np.asarray(pts, dtype=object).reshape(-1)]


# vpin_tpu's conv on the CPU is compile-bound: a cold 2x2 run_conv_workload
# takes minutes (tests/test_nn.py marks its 4x4 conv slow for the same reason)
@pytest.mark.slow
def test_slice_trace_matches_jax(both):
    jfin, fin = both["jfin"], both["fin"]
    assert both["jres"].num_mults == both["res"].num_mults == 18
    assert both["jres"].num_adds == both["res"].num_adds == 16
    assert set(fin) == set(jfin)
    for k in jfin:
        assert [int(v) for v in np.asarray(fin[k], dtype=object)] == [
            int(v) for v in np.asarray(jfin[k], dtype=object)], k


# compile-bound on the CPU, as above
@pytest.mark.slow
def test_slice_export_bytes_match_jax(both):
    names = sorted(p.relative_to(both["jdir"])
                   for p in both["jdir"].rglob("*.json"))
    assert len(names) == 8
    assert names == sorted(p.relative_to(both["pdir"])
                           for p in both["pdir"].rglob("*.json"))
    for name in names:
        assert (both["pdir"] / name).read_bytes() == \
            (both["jdir"] / name).read_bytes(), name


# compile-bound on the CPU, as above
@pytest.mark.slow
def test_slice_ciphertexts_and_outputs_match_jax(both):
    from vpin_tpu.curve.weierstrass import E2 as JE2
    res = both["res"]
    for jhalf, half in zip(both["jct"], res.ciphertext):
        assert _affine(JE2.to_affine_host(jhalf)) == _affine(
            E2.to_affine_host(half))
    assert len(both["jouts"]) == 2
    for jout, out in zip(both["jouts"], res.outputs):
        assert _affine(JE2.to_affine_host(jout)) == _affine(
            E2.to_affine_host(out))
