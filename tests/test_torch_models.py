"""The port's CNN serving layers and pipelines (vpin_tpu_torch.nn:
avgpool2d, fc, channel_sum, run_cnn_workload, run_lenet_workload, the CLI's
cnn and bsgs) on the CPU, where K1-K3 run their plain PyTorch versions.

Tolerance: exact.  The fast tier holds every layer's output and its recorded
witness against the exact host arithmetic of curve/host_ec.py, with the
trace counts of tests/test_nn.py.  The slow tier runs CNN A and LeNet in
both packages on the same key, nonce seed, rLC keys, weights and BSGS table
and requires equal traces, export bytes, logits and layer slices; and it
proves a 253-bit mult instance in both packages and requires equal proof
bytes.
"""

import json
import pickle
import random

import numpy as np
import pytest
import torch

from vpin_tpu_torch import convert
from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER, host_infinity
from vpin_tpu_torch.curve.weierstrass import E2, PointW
from vpin_tpu_torch.nn import (
    BsgsTable, HomomorphicEngine, KeyPair, channel_sum, encrypt_batch,
)
from vpin_tpu_torch.nn import models
from vpin_tpu_torch.nn.fixed_point import pool_reciprocal_fixed
from vpin_tpu_torch.nn.homomorphic import _window_indices
from vpin_tpu_torch.nn.prf import pf_vector
from vpin_tpu_torch.runner import cli

from test_torch_bsgs import host_table

RNG = random.Random(42)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keypair():
    return KeyPair.generate(random.Random(1), device="cpu")


def host(P: PointW) -> np.ndarray:
    return E2.to_affine_host(P)


def host_sum(points):
    acc = host_infinity()
    for P in points:
        acc = acc + P
    return acc


def trace_points(fin, prefix, flags):
    from vpin_tpu_torch.curve.host_ec import E2_HOST, HostPoint
    xs, ys, infs = fin[prefix + "x"], fin[prefix + "y"], fin[flags]
    return [HostPoint(E2_HOST, int(x), int(y), bool(i))
            for x, y, i in zip(xs, ys, infs)]


def test_avgpool_outputs_and_trace_match_host(keypair):
    img = np.array([[RNG.randrange(0, 30) for _ in range(4)] for _ in range(4)])
    ct = encrypt_batch(img, keypair, random.Random(4))
    eng = HomomorphicEngine(prf_trunc_bytes=14)
    pooled = [eng.avgpool2d(h, kernel_size=2, stride=2) for h in ct]
    # (k^2 - 1) recorded adds per output pixel per half: 2 * 4 * 3
    assert eng.trace.num_adds == 24 and eng.trace.num_mults == 0
    fin = eng.trace.finalize()
    lefts = trace_points(fin, "add_p", "add_p_inf")
    rights = trace_points(fin, "add_r", "add_r_inf")
    idx, OH, OW = _window_indices(4, 4, 2, 0, 2)
    scale = pool_reciprocal_fixed(2)
    t = 0
    for half, out in zip(ct, pooled):
        pts = host(half).reshape(-1)
        got = host(out)
        assert got.shape == (OH, OW)
        for m in range(OH * OW):
            win = [pts[i] for i in idx[m]]
            assert got.reshape(-1)[m] == scale * host_sum(win)
            # pixel-major running sums: (acc_t, win[t + 1])
            for k in range(3):
                assert lefts[t] == host_sum(win[:k + 1])
                assert rights[t] == win[k + 1]
                t += 1


def fc_case(keypair, W, seed):
    """One FC layer over both halves of an encrypted 4-vector; returns the
    inputs, biases, outputs, keys and the engine."""
    x = [RNG.randrange(0, 30) for _ in range(W.shape[0])]
    b = [RNG.randrange(0, 20) for _ in range(W.shape[1])]
    ct = encrypt_batch(x, keypair, random.Random(seed))
    bias = encrypt_batch(b, keypair, random.Random(seed + 1))
    eng = HomomorphicEngine(prf_trunc_bytes=14)
    keys = [bytes([seed, h]) * 16 for h in range(2)]
    outs = [eng.fc(ct[h], W.astype(object), bias[h], key=keys[h])
            for h in range(2)]
    assert eng.flush_checks()
    return ct, bias, outs, keys, eng


@pytest.mark.parametrize("case", ["small", "wide"])
def test_fc_outputs_and_trace_match_host(keypair, case):
    """4 -> 3 with negative weights; "wide" has rLC-combined scalars of
    128 bits and more (reduced mod the group order) beside negative ones
    under 2^128 (sign-folded)."""
    if case == "small":
        W = np.array([[1, -2, 3], [0, 4, -1], [-5, 2, 2], [3, 3, -3]])
    else:
        W = np.array([[1 << 20, 1 << 20, 1 << 20], [-3, -5, -7],
                      [2, -1, 0], [-(1 << 22), 5, 1]])
    ct, bias, outs, keys, eng = fc_case(keypair, W, 5)
    n_in, n_out = W.shape
    # per half: n_out bias adds + (n_in - 1) rLC adds; n_in rLC mults
    assert eng.trace.num_mults == 2 * n_in
    assert eng.trace.num_adds == 2 * (n_out + n_in - 1)
    fin = eng.trace.finalize()
    bases = trace_points(fin, "mult_p", "mult_inf")
    lefts = trace_points(fin, "add_p", "add_p_inf")
    rights = trace_points(fin, "add_r", "add_r_inf")
    scalars = list(fin["mult_scalars"])
    saw_wide = saw_folded = False
    for h in range(2):
        P = host(ct[h])
        B = host(bias[h])
        C = [host_sum(int(W[k, j]) * P[k] for k in range(n_in))
             for j in range(n_out)]
        assert list(host(outs[h])) == [C[j] + B[j] for j in range(n_out)]
        rho = pf_vector(keys[h], n_out, 14)
        s = [sum(rho[j] * int(W[k, j]) for j in range(n_out))
             for k in range(n_in)]
        want_bases, want_scalars = [], []
        for k, v in enumerate(s):
            if abs(v) < (1 << 128):
                want_bases.append(-P[k] if v < 0 else P[k])
                want_scalars.append(abs(v))
                saw_folded |= v < 0
            else:
                want_bases.append(P[k])
                want_scalars.append(v % E2_ORDER)
                saw_wide = True
        assert bases[h * n_in:(h + 1) * n_in] == want_bases
        assert scalars[h * n_in:(h + 1) * n_in] == want_scalars
        a0 = h * (n_out + n_in - 1)
        assert lefts[a0:a0 + n_out] == C and rights[a0:a0 + n_out] == list(B)
        temps = [w * Q for w, Q in zip(want_scalars, want_bases)]
        for t in range(n_in - 1):
            assert lefts[a0 + n_out + t] == host_sum(temps[:t + 1])
            assert rights[a0 + n_out + t] == temps[t + 1]
    assert saw_folded
    assert saw_wide == (case == "wide")


def test_channel_sum_matches_host(keypair):
    a = np.array([[1, 2], [3, 4]])
    b = np.array([[10, 20], [30, 40]])
    c = np.array([[-5, 0], [7, 100]])
    cts = [encrypt_batch(v, keypair, random.Random(6 + i))
           for i, v in enumerate((a, b, c))]
    for i in range(2):
        got = host(channel_sum([ct[i] for ct in cts]))
        parts = [host(ct[i]) for ct in cts]
        assert got.shape == (2, 2)
        for r in range(2):
            for col in range(2):
                assert got[r, col] == host_sum(p[r, col] for p in parts)


def test_weights_from_jax_checks_shapes():
    w = models.make_random_weights(4, 6)
    out = convert.weights_from_jax({k: v.astype(np.float64)
                                    for k, v in w.items()})
    assert all(out[k].dtype == np.float32 and np.array_equal(out[k], w[k])
               for k in w)
    with pytest.raises(ValueError):
        convert.weights_from_jax(dict(w, bias_fc1=w["bias_fc1"][:5]))


@pytest.mark.parametrize("env", [None, "elsewhere"])
def test_reference_dir_matches_vpin_tpu(monkeypatch, tmp_path, env):
    """With $VPIN_REFERENCE unset both packages look in the same default
    directory, and with it set in the same place under it."""
    from vpin_tpu.nn import models as jmodels
    if env is None:
        monkeypatch.delenv("VPIN_REFERENCE", raising=False)
    else:
        monkeypatch.setenv("VPIN_REFERENCE", str(tmp_path / env))
    asked = []

    def no_file(path, *args, **kwargs):
        asked.append(str(path))
        raise OSError(f"no {path}")

    monkeypatch.setattr(np, "load", no_file)
    paths = []
    for mod in (jmodels, models):
        asked.clear()
        assert mod.load_reference_image(32) is None
        assert mod.load_pretrained_weights("A") is None
        assert mod.load_pretrained_weights(lenet=True) is None
        paths.append(list(asked))
    assert len(paths[0]) == 3 and paths[0] == paths[1]


def host_cache(path, m):
    """A table cache in the reference's format, from host j*G."""
    keys, perm = host_table(m)
    with open(path, "wb") as fh:
        pickle.dump({"m": m, "keys": keys, "perm": perm}, fh)


def test_cli_cnn_on_cpu(tmp_path, capsys, monkeypatch):
    """CNN A on a 4x4 image (pool 4x4 -> one FC1 input), weights of scale
    1e-3, the table from a cache at m = 2^18 and 2,048 giant steps (K = 32)
    so the plain versions decrypt in a few rounds.  --prove hands the trace
    to the prover (its proofs are held against vpin_tpu elsewhere)."""
    from vpin_tpu_torch.runner import proof_runner
    proved = []
    monkeypatch.setattr(proof_runner, "prove_trace",
                        lambda trace, **kw: proved.append((trace, kw)))
    cache = tmp_path / "t.pkl"
    host_cache(cache, 1 << 18)
    assert cli.main(["cnn", "--version", "A", "--size", "4", "--seed", "1",
                     "--device", "cpu", "--bsgs-m", str(1 << 18),
                     "--bsgs-cache", str(cache), "--weight-scale", "1e-3",
                     "--max-steps", "2048", "--export", str(tmp_path / "out"),
                     "--prove"]) == 0
    out = capsys.readouterr().out
    # conv 2 x (9 mults, 8 adds); pool 2 x 15 adds; FC1 1 -> 16:
    # 2 x (1 mult, 16 + 0 adds); FC2 16 -> 10: 2 x (16 mults, 10 + 15 adds)
    assert "multiplications: 52" in out and "additions: 128" in out
    assert "Logits: [" in out and "Giant-step rounds per decryption" in out
    weights = json.loads((tmp_path / "out" / "pointMult" / "weight.json")
                         .read_text())
    assert len(weights) == 52
    (trace, kw), = proved
    assert trace.num_mults == 52 and kw["full_snark"] and kw["tape_seed"] == 1


def test_cli_bsgs_on_cpu(tmp_path, capsys):
    cache = tmp_path / "b.pkl"
    assert cli.main(["bsgs", "--m", "512", "--cache", str(cache),
                     "--device", "cpu"]) == 0
    assert "m=512 entries=511" in capsys.readouterr().out
    with open(cache, "rb") as fh:
        data = pickle.load(fh)
    assert data["m"] == 512 and data["keys"].dtype == np.uint64
    table = BsgsTable.build(512, cache_path=str(cache), device="cpu")
    assert np.array_equal(table.perm, data["perm"])


# ----------------------------------------------------------------------
# slow tier: the same pipelines through vpin_tpu
# ----------------------------------------------------------------------

def tiny_weights(n_in, n_hidden):
    """tests/test_models.py's signed weights (seed 3, scale 1e-3), small
    enough that FC outputs stay BSGS-decodable."""
    return models.make_random_weights(n_in, n_hidden, seed=3, scale=1e-3)


def rlc_keys():
    counter = iter(range(1 << 20))
    return lambda: next(counter).to_bytes(4, "little") * 8


@pytest.fixture(scope="module")
def jtable(tmp_path_factory):
    """tests/test_models.py's table size (m = 2^20), read by vpin_tpu from a
    cache written from host arithmetic: its own build is an XLA compile of
    half an hour on the CPU (test_torch_bsgs.py holds its builder against
    the port's at m = 4,096)."""
    from vpin_tpu.nn.bsgs import BsgsTable as JBsgsTable
    path = tmp_path_factory.mktemp("bsgs") / "t.pkl"
    host_cache(path, 1 << 20)
    return JBsgsTable.build(m=1 << 20, cache_path=str(path))


def run_both(jtable, run_jax, run_port):
    """Run a pipeline in both packages with the same key pair, rLC keys and
    table, require equal finalized traces and logits, and return (jax
    result, port result, their finalized traces)."""
    import jax
    from vpin_tpu.nn import models as jmodels
    from vpin_tpu.nn.elgamal import KeyPair as JKeyPair
    jdecrypt = jmodels.decrypt_batch

    def decrypt(*args, **kwargs):
        # each of vpin_tpu's XLA-CPU executables holds memory mappings, and
        # a whole pipeline's pass the kernel's default limit of 65,530 (the
        # compile then fails): drop them at each client round trip
        out = jdecrypt(*args, **kwargs)
        jax.clear_caches()
        return out

    jax.clear_caches()
    jkey = JKeyPair.generate(random.Random(5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodels, "fresh_key", rlc_keys())
        mp.setattr(jmodels, "decrypt_batch", decrypt)
        jres = run_jax(jmodels, jkey, jtable)
    torch.set_num_threads(4)            # the decryptions' rounds are wide
    try:
        res = run_port(convert.keypair_from_jax(jkey, "cpu"),
                       convert.bsgs_table_from_jax(jtable))
    finally:
        torch.set_num_threads(1)
    jfin, fin = jres.trace.finalize(), res.trace.finalize()
    assert set(fin) == set(jfin)
    for k in jfin:
        assert [int(v) for v in np.asarray(fin[k], dtype=object)] == [
            int(v) for v in np.asarray(jfin[k], dtype=object)], k
    assert np.array_equal(res.logits, jres.logits)
    return jres, res, jfin, fin


def exports_equal(jtrace, trace, jfin, fin, tmp_path, **slices):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jtrace.export_json(str(jdir), _finalized=jfin, **slices)
    trace.export_json(str(pdir), _finalized=fin, **slices)
    names = sorted(p.relative_to(jdir) for p in jdir.rglob("*.json"))
    assert len(names) == 8
    for name in names:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), name


# vpin_tpu's pipeline on the CPU is compile-bound (tests/test_models.py is
# slow for the same reason), and the port's plain decryptions take minutes
@pytest.mark.slow
def test_cnn_a_equals_vpin_tpu(jtable, tmp_path):
    img = np.random.RandomState(11).rand(8, 8)
    w = tiny_weights(4, 6)
    jres, res, jfin, fin = run_both(
        jtable,
        lambda jm, k, t: jm.run_cnn_workload("A", img, k, t, weights=w,
                                             rng=random.Random(2),
                                             max_steps=100_000),
        lambda k, t: models.run_cnn_workload(
            "A", img, k, t, weights=convert.weights_from_jax(w),
            rng=random.Random(2), max_steps=100_000, key_source=rlc_keys()))
    assert res.num_mults == 2 * (9 + 4 + 6)
    assert res.num_adds == 2 * (8 + 60 + 6 + 3 + 10 + 5)
    exports_equal(jres.trace, res.trace, jfin, fin, tmp_path)


# compile-bound in vpin_tpu, minutes of plain decryptions in the port
@pytest.mark.slow
def test_lenet_equals_vpin_tpu(jtable, tmp_path):
    img = np.random.RandomState(12).rand(32, 32)
    w = tiny_weights(2, 3)
    jres, res, jfin, fin = run_both(
        jtable,
        lambda jm, k, t: jm.run_lenet_workload(img, k, t, weights=w,
                                               rng=random.Random(4),
                                               num_kernels=(1, 1, 2),
                                               max_steps=100_000),
        lambda k, t: models.run_lenet_workload(
            img, k, t, weights=convert.weights_from_jax(w),
            rng=random.Random(4), num_kernels=(1, 1, 2), max_steps=100_000,
            key_source=rlc_keys()))
    assert res.layer_slices == jres.layer_slices
    assert res.num_mults == 50 + 50 + 100 + 4 + 6
    msl, asl = res.layer_slices["L5"]
    exports_equal(jres.trace, res.trace, jfin, fin, tmp_path,
                  mult_slice=msl, add_slice=asl)


# the 253-bit witness scan makes about 2 x 10^5 serial plain K1 calls
# (minutes on one CPU thread), and vpin_tpu's side is compile-bound
@pytest.mark.slow
def test_253_bit_mult_proof_equals_vpin_tpu(monkeypatch):
    """tests/test_snark.py's wide case (seed 61: one scalar above 2^128, so
    prove_point_mult takes the 253-bit gadget), transparent, tape seed 13:
    equal proof bytes in both packages."""
    import contextlib
    import io

    from vpin_tpu.runner import proof_runner as jrunner
    from vpin_tpu.utils.bincode import serialize_snark as jser
    from vpin_tpu_torch.runner import proof_runner
    from vpin_tpu_torch.utils.bincode import serialize_snark

    rng = random.Random(61)
    w_wide = rng.randrange(1 << 200, 1 << 220)
    w_small = rng.randrange(1, 1 << 100)
    ws, px, py = [], [], []
    for w in (w_wide, w_small):
        P = rng.randrange(1, E2_ORDER) * E2_G_HOST
        ws.append(w)
        px.append(P.x)
        py.append(P.y)

    proofs = {}
    for name, mod, ser, kw in (("jax", jrunner, jser, {}),
                               ("port", proof_runner, serialize_snark,
                                {"device": "cpu"})):
        inner = mod._prove_gadget

        def capture(gadget, *args, _inner=inner, _name=name, _ser=ser,
                    **kwargs):
            out = _inner(gadget, *args, **kwargs)
            proofs[_name] = (_ser(out[0]), gadget[5])
            return out

        monkeypatch.setattr(mod, "_prove_gadget", capture)
        with contextlib.redirect_stdout(io.StringIO()):
            st = mod.prove_point_mult(ws, px, py, tape_seed=13,
                                      full_snark=False, **kw)
        assert st.size_bytes == len(proofs[name][0])
    (jblob, jnc), (pblob, pnc) = proofs["jax"], proofs["port"]
    from vpin_tpu_torch.gadgets import point_mult
    assert pnc == jnc == point_mult.build_matrices(2, 253)[3]
    assert pblob == jblob
