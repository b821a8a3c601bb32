"""The port's CP-SNARK (vpin_tpu_torch: poly, sumcheck, snark, gadgets,
runner) on the CPU, where K1 and K4 run their plain PyTorch versions,
against vpin_tpu and its golden vectors: the transparent proofs here, the
SPARK eval proof in test_torch_spark.py.

Tolerance: exact.  Field tables are compared as canonical ints; proofs as
the Fiat-Shamir challenge streams of prover and verifier and the bincode
bytes of crosscheck/golden/ (vpin_tpu's own wire format).

Slow tier: the 2-mult golden fixture (its 128-step witness scan makes about
10^5 serial K1 calls, 100+ s on one CPU thread), the same fixture with every
table on the tensor route, and the whole slice (a conv trace proven by both
packages, the adds with the eval proof).
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from vpin_tpu.field.prime_field import FQ as JFQ
from vpin_tpu.poly.dense import DensePoly as JDensePoly
from vpin_tpu.poly.dense import eq_evals as jeq_evals
from vpin_tpu.snark.r1cs import SparseMat as JSparseMat
from vpin_tpu.sumcheck.sumcheck import _round_evals as j_round_evals
from vpin_tpu_torch import convert
from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER
from vpin_tpu_torch.field import FQ
from vpin_tpu_torch.field.prime_field import L_MODULUS as L
from vpin_tpu_torch.gadgets import (
    point_addition, point_addition_gadget, point_mult, point_mult_gadget,
)
from vpin_tpu_torch.gadgets.point_addition import build_matrices
from vpin_tpu_torch.poly import dense
from vpin_tpu_torch.poly.dense import DensePoly, eq_evals, eq_evals_host
from vpin_tpu_torch.runner import cli
from vpin_tpu_torch.runner.proof_runner import trace_args
from vpin_tpu_torch.snark import (
    SNARKGens, cp_commit_witness, cp_snark_prove, cp_snark_verify,
    snark_encode,
)
from vpin_tpu_torch.snark.r1cs import SparseMat
from vpin_tpu_torch.sumcheck.sumcheck import bind_tables, round_evals
from vpin_tpu_torch.transcript import Transcript
from vpin_tpu_torch.utils.bincode import deserialize_snark, serialize_snark

GOLDEN = Path(__file__).resolve().parent.parent / "crosscheck" / "golden"
RS = np.random.RandomState(31)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(n):
    """n field elements: 0, 1 and l - 1 first, then uniform ones."""
    vals = [int.from_bytes(RS.bytes(32), "little") % L for _ in range(n)]
    return ([0, 1, L - 1] + vals[3:])[:n]


def _both(vals):
    """Host ints -> (port Montgomery tensor, vpin_tpu Montgomery array)."""
    return FQ.to_mont(vals, "cpu"), JFQ.to_mont(vals)


def _port_ints(t):
    return [int(v) for v in FQ.from_mont(t).reshape(-1)]


def _jax_ints(a):
    return [int(v) for v in JFQ.from_mont(a).reshape(-1)]


# ----------------------------------------------------------------------
# table pieces against vpin_tpu on 2^10 tables
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 1000, 1 << 10])
def test_sum_reduce_equals_vpin_tpu(n):
    vals = _ints(n)
    t, j = _both(vals)
    want = int(JFQ.from_mont(JFQ.sum_reduce(j)))
    assert int(FQ.from_mont(FQ.sum_reduce(t))) == want == sum(vals) % L
    if n >= 8:
        k = n // 8 * 8
        rows = t[:k].reshape(8, -1, 8)           # sums along a middle axis
        assert _port_ints(FQ.sum_reduce(rows, axis=1)) == [
            sum(vals[i * k // 8:(i + 1) * k // 8]) % L for i in range(8)]


def test_limbs_to_bits_and_vector_repack_equal_vpin_tpu():
    vals = _ints(64)
    t, j = _both(vals)
    assert torch.equal(convert.fq_vector_from_jax(np.asarray(j), "cpu"), t)
    plain = FQ.limbs_to_bits(FQ.mul(t, FQ.ones((), "cpu")), 253)
    want = JFQ.limbs_to_bits(JFQ.mul(j, JFQ.ones(())), 253)
    assert np.array_equal(plain.numpy(), np.asarray(want))
    assert plain.shape == (64, 253) and plain.dtype == torch.int32


def test_dense_poly_equals_vpin_tpu():
    vals = _ints(1 << 10)
    t, j = _both(vals)
    port, ref = DensePoly(t), JDensePoly(j)
    rs = _ints(10)[3:] + [5, 6, 7]
    assert port.evaluate(rs) == ref.evaluate(rs) == \
        DensePoly(list(vals)).evaluate(rs)
    L_vec = _ints(32)
    got = _port_ints(port.bound_L(FQ.to_mont(L_vec, "cpu")))
    assert got == _jax_ints(ref.bound_L(JFQ.to_mont(L_vec))) == \
        DensePoly(list(vals)).bound_L(L_vec)
    for r in (rs[0], rs[1]):
        port.bound_poly_var_top(r)
        ref.bound_poly_var_top(r)
        assert _port_ints(port.Z) == _jax_ints(ref.Z)
    assert _port_ints(eq_evals(rs, "cpu")) == _jax_ints(jeq_evals(rs)) == \
        eq_evals_host(rs)


@pytest.mark.parametrize("kind,k", [("quad", 2), ("cubic_additive", 4)])
def test_sumcheck_round_equals_vpin_tpu(kind, k):
    tabs = [_both(_ints(1 << 10)) for _ in range(k)]
    got = round_evals(kind, [t for t, _ in tabs])
    want = [int(JFQ.from_mont(v)) for v in j_round_evals(kind, *(j for _, j in tabs))]
    assert got == want
    r = _ints(4)[3]
    bound = bind_tables([t for t, _ in tabs], r)
    for b, (_, j) in zip(bound, tabs):
        ref = JDensePoly(j)
        ref.bound_poly_var_top(r)
        assert _port_ints(b) == _jax_ints(ref.Z)


def test_sparse_mat_equals_vpin_tpu():
    """The point-add gadget's matrices for 64 adds (640 x 961 -> 2^10
    columns of variables) against vpin_tpu's bucketed reductions."""
    A, _, _, _, _, _ = build_matrices(64)
    port, ref = SparseMat(A, 1024, 2048), JSparseMat(A, 1024, 2048)
    z, jz = _both(_ints(2048))
    got = port.multiply_vec(2048, z)
    assert _port_ints(got) == _jax_ints(ref.multiply_vec(2048, jz))
    assert _port_ints(got) == port.multiply_vec_host(_port_ints(z))
    rx, jrx = _both(_ints(1024))
    got = port.compute_eval_table(rx, 2048)
    assert _port_ints(got) == _jax_ints(ref.compute_eval_table(jrx, 2048))
    eq_rx, eq_ry = eq_evals_host(_ints(10)), eq_evals_host(_ints(11))
    want = ref.evaluate(JFQ.to_mont(eq_rx), JFQ.to_mont(eq_ry))
    assert port.evaluate(FQ.to_mont(eq_rx, "cpu"), FQ.to_mont(eq_ry, "cpu")) \
        == port.evaluate_host(eq_rx, eq_ry) == want


# ----------------------------------------------------------------------
# golden fixtures (crosscheck/gen_golden.py), no JAX
# ----------------------------------------------------------------------

def add_fixture_trace():
    rng = random.Random(2024)
    px, py, rx, ry, rz = [], [], [], [], []
    for t in range(2):
        P = rng.randrange(1, E2_ORDER) * E2_G_HOST
        if t == 1:
            rz.append(1)
            rx.append(0)
            ry.append(0)
        else:
            R = rng.randrange(1, E2_ORDER) * E2_G_HOST
            rz.append(0)
            rx.append(R.x)
            ry.append(R.y)
        px.append(P.x)
        py.append(P.y)
    return px, py, rx, ry, rz


def mult_fixture_trace():
    rng = random.Random(2025)
    ws, px, py = [], [], []
    for _ in range(2):
        ws.append(rng.randrange(1, 1 << 128))
        P = rng.randrange(1, E2_ORDER) * E2_G_HOST
        px.append(P.x)
        py.append(P.y)
    return ws, px, py


def replay(gadget, fname):
    """Prove and verify a fixture with tape seed 11 and hold both challenge
    streams and the proof bytes against the golden file."""
    golden = json.loads((GOLDEN / fname).read_text())
    inst, vp, vi, vf, inputs, nc, nv, ni, nnz = gadget
    gens = SNARKGens(nc, nv, ni, nnz)
    pv, cv, bv, cpc, cic = cp_commit_witness(vp, vi, vf, gens, tape_seed=11,
                                             device="cpu")
    plog, vlog = [], []
    proof = cp_snark_prove(inst, vf, inputs, gens,
                           Transcript(b"snark_example", log=plog), pv, cv, bv,
                           tape_seed=11)
    assert cp_snark_verify(proof, inst, inputs,
                           Transcript(b"snark_example", log=vlog), gens,
                           cpc, cic)
    assert [list(x) for x in plog] == [list(x) for x in
                                       golden["prover_challenges"]]
    assert [list(x) for x in vlog] == [list(x) for x in
                                       golden["verifier_challenges"]]
    blob = serialize_snark(proof)
    assert blob.hex() == golden["proof_hex"]
    return proof, blob, (inst, inputs, gens, cpc, cic), pv


def test_point_add_golden_fixture_replays():
    gadget = point_addition_gadget(*add_fixture_trace(), device="cpu")
    proof, blob, (inst, inputs, gens, cpc, cic), pv = replay(
        gadget, "point_add_cp_challenges.json")
    assert len(blob) == 4672
    back = deserialize_snark(blob)
    assert serialize_snark(back) == blob
    assert cp_snark_verify(back, inst, inputs, Transcript(b"snark_example"),
                           gens, cpc, cic)
    bad = deserialize_snark(blob)
    bad.inst_evals = ((bad.inst_evals[0] + 1) % L,) + bad.inst_evals[1:]
    assert not cp_snark_verify(bad, inst, inputs,
                               Transcript(b"snark_example"), gens, cpc, cic)
    with pytest.raises(ValueError):
        deserialize_snark(blob + b"\x00")
    # the full SNARK over the same witness: its bytes extend the transparent
    # proof's with the eval proof, and no mode is taken for the other
    _, vp, vi, vf, *_ = gadget
    comm, decomm = snark_encode(inst, gens)
    pv, cv, bv, cpc, cic = cp_commit_witness(vp, vi, vf, gens, tape_seed=11,
                                             device="cpu")
    full = cp_snark_prove(inst, vf, inputs, gens,
                          Transcript(b"snark_example"), pv, cv, bv,
                          decomm=decomm, tape_seed=11, with_eval_proof=True)
    fblob = serialize_snark(full)
    assert len(fblob) == 16880 and fblob[:len(blob)] == blob
    back = deserialize_snark(fblob)
    assert serialize_snark(back) == fblob
    assert cp_snark_verify(back, inst, inputs, Transcript(b"snark_example"),
                           gens, cpc, cic, comm=comm)
    assert not cp_snark_verify(back, inst, inputs,
                               Transcript(b"snark_example"), gens, cpc, cic)
    assert not cp_snark_verify(proof, inst, inputs,
                               Transcript(b"snark_example"), gens, cpc, cic,
                               comm=comm)
    with pytest.raises(ValueError, match="decommitment"):
        cp_snark_prove(inst, vf, inputs, gens, Transcript(b"snark_example"),
                       pv, cv, bv, with_eval_proof=True)


# about 10^5 serial K1 calls in the witness scan: 100+ s on one CPU thread
@pytest.mark.slow
def test_point_mult_golden_fixture_replays():
    gadget = point_mult_gadget(*mult_fixture_trace(), n=128, device="cpu")
    _, blob, _, pv = replay(gadget, "point_mult_cp_challenges.json")
    assert len(blob) == 11840 and pv.is_host


def tensor_route(monkeypatch):
    """Lower every crossover so that the witness, its commit, the sumcheck
    tables and the matrix products all take the tensor route."""
    monkeypatch.setattr(dense, "HOST_POLY_MAX", 0)
    monkeypatch.setattr(point_addition, "DEVICE_WITNESS_THRESHOLD", 0)
    monkeypatch.setattr(point_mult, "DEVICE_WITNESS_THRESHOLD", 0)


def test_point_add_golden_fixture_on_the_tensor_route(monkeypatch):
    tensor_route(monkeypatch)
    gadget = point_addition_gadget(*add_fixture_trace(), device="cpu")
    assert isinstance(gadget[3], torch.Tensor)
    _, blob, _, pv = replay(gadget, "point_add_cp_challenges.json")
    assert len(blob) == 4672 and not pv.is_host


# the same witness scan, then every table on the tensor route
@pytest.mark.slow
def test_point_mult_golden_fixture_on_the_tensor_route(monkeypatch):
    tensor_route(monkeypatch)
    gadget = point_mult_gadget(*mult_fixture_trace(), n=128, device="cpu")
    assert isinstance(gadget[3], torch.Tensor)
    _, blob, _, pv = replay(gadget, "point_mult_cp_challenges.json")
    assert len(blob) == 11840 and not pv.is_host


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def _write_rust_files(d: Path, trace) -> None:
    """A point-add witness in the rust_files/<tag> layout, no pointMult."""
    px, py, rx, ry, rz = trace
    (d / "pointAdd").mkdir(parents=True)

    def dump(name, rows):
        (d / "pointAdd" / name).write_text(json.dumps(rows))

    def byte_rows(vals):
        return [list(int(v).to_bytes(32, "little")) for v in vals]

    dump("point_add_px_byte.json", byte_rows(px))
    dump("point_add_py_byte.json", byte_rows(py))
    dump("point_add_rx_byte.json", byte_rows(rx))
    dump("point_add_ry_byte.json", byte_rows(ry))
    dump("point_add_rz_byte.json", list(rz))


def test_cli_prove_dir_round_trip(tmp_path, capsys, monkeypatch):
    _write_rust_files(tmp_path / "tag", add_fixture_trace())
    args = ["prove", "--dir", str(tmp_path / "tag"), "--seed", "11",
            "--device", "cpu"]
    assert cli.main(args + ["--transparent"]) == 0
    out = capsys.readouterr().out
    assert "Number of Point Additions: 2" in out
    assert "Proof size: 4672 bytes" in out
    assert "Proof verification successful!" in out
    assert "Number of Point Multiplications: 0" in out
    assert "Total proof size: 4672 bytes" in out
    # without --transparent: the full SNARK, with the eval proof
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "Proof size: 16880 bytes" in out
    assert "Proof verification successful!" in out
    assert "Total proof size: 16880 bytes" in out
    # conv --prove passes the same switch to the prover
    from vpin_tpu_torch.nn import models
    from vpin_tpu_torch.runner import proof_runner

    class Workload:
        num_mults, num_adds, trace = 18, 16, None

    seen = []
    monkeypatch.setattr(models, "run_conv_workload", lambda *a: Workload())
    monkeypatch.setattr(proof_runner, "prove_trace",
                        lambda trace, **kw: seen.append(kw["full_snark"]))
    for extra in ([], ["--transparent"]):
        assert cli.main(["conv", "--size", "2", "--prove", "--device", "cpu"]
                        + extra) == 0
    assert seen == [True, False]


# ----------------------------------------------------------------------
# slow tier: the whole slice through both packages
# ----------------------------------------------------------------------

@pytest.mark.slow
def test_slice_proofs_equal_vpin_tpu():
    """A port conv trace (2x2 image, fixed rLC keys) proven by both packages
    with the same tape seed over adds [0, 4), with the eval proof, and mults
    [0, 2), transparent: equal proof bytes, and each package's verifier
    accepts both.  (The 2-mult eval proof on the CPU takes about 45 min in
    each package; test_torch_spark.py replays its golden fixture.)"""
    from vpin_tpu.gadgets.point_addition import point_addition_gadget as jpa
    from vpin_tpu.gadgets.point_mult import point_mult_gadget as jpm
    from vpin_tpu.snark import SNARKGens as JGens
    from vpin_tpu.snark import cp_commit_witness as jcommit
    from vpin_tpu.snark import cp_snark_prove as jprove
    from vpin_tpu.snark import cp_snark_verify as jverify
    from vpin_tpu.snark.cp_snark import snark_encode as jencode
    from vpin_tpu.transcript.merlin import Transcript as JTranscript
    from vpin_tpu.utils.bincode import deserialize_snark as jdes
    from vpin_tpu.utils.bincode import serialize_snark as jser
    from vpin_tpu_torch.nn import KeyPair, run_conv_workload

    keys = iter((b"\x01" * 32, b"\x02" * 32))
    key = KeyPair.generate(random.Random(3), device="cpu")
    img = np.random.RandomState(1).uniform(0.0, 1.0, (2, 2)).astype(np.float32)
    res = run_conv_workload(img, 3, key, random.Random(4),
                            key_source=lambda: next(keys))
    add, mult = trace_args(res.trace.finalize(), (0, 4), (0, 2))

    for port_gadget, ref_gadget, full in (
            (point_addition_gadget(*add, device="cpu"), jpa(*add), True),
            (point_mult_gadget(*mult, device="cpu"), jpm(*mult), False)):
        blobs = []
        for gadget, Gens, encode, commit, prove, ser, T, kw in (
                (port_gadget, SNARKGens, snark_encode, cp_commit_witness,
                 cp_snark_prove, serialize_snark, Transcript,
                 {"device": "cpu"}),
                (ref_gadget, JGens, jencode, jcommit, jprove, jser,
                 JTranscript, {})):
            inst, vp, vi, vf, inputs, nc, nv, ni, nnz = gadget
            gens = Gens(nc, nv, ni, nnz)
            comm, decomm = encode(inst, gens) if full else (None, None)
            pv, cv, bv, cpc, cic = commit(vp, vi, vf, gens, tape_seed=5, **kw)
            proof = prove(inst, vf, inputs, gens, T(b"snark_example"), pv, cv,
                          bv, decomm=decomm, tape_seed=5,
                          with_eval_proof=full)
            blobs.append((ser(proof), inst, inputs, gens, cpc, cic, comm))
        (pblob, *pctx), (jblob, *jctx) = blobs
        assert pblob == jblob
        inst, inputs, gens, cpc, cic, comm = pctx
        assert cp_snark_verify(deserialize_snark(jblob), inst, inputs,
                               Transcript(b"snark_example"), gens, cpc, cic,
                               comm=comm)
        inst, inputs, gens, cpc, cic, comm = jctx
        assert jverify(jdes(pblob), inst, inputs,
                       JTranscript(b"snark_example"), gens, cpc, cic,
                       comm=comm)
