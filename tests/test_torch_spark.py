"""The port's SPARK eval proof (vpin_tpu_torch/spark, the non-ZK sumcheck,
the full CP-SNARK) on the CPU, where K1 and K4 run their plain PyTorch
versions, against vpin_tpu and the full-SNARK golden vectors.

Tolerance: exact.  Timestamps and field values are compared as ints,
commitments and proofs as bytes, Fiat-Shamir transcripts as the challenge
streams they produce.  The SPARK runs on Montgomery tensors; every prover
runs with the port's default crossovers (the tables outside the SPARK on
host ints where small) and with every table on tensors (HOST_POLY_MAX and
the witness thresholds lowered to 0).

Slow tier: the 2-mult full-SNARK golden fixture (the 128-step witness scan,
100+ s on one CPU thread, then a SPARK instance of 2^14 nonzeros on the
tensor route).
"""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from vpin_tpu.poly.dense import DensePoly as JDensePoly
from vpin_tpu.snark.r1cs import SparseMat as JSparseMat
from vpin_tpu.spark import multi_commit as jmulti_commit
from vpin_tpu.spark.product_tree import (
    BatchedDotProducts as JDotProducts,
    BatchedProductCircuits as JProductCircuits,
    ProductCircuitEvalProofBatched as JProductProof,
)
from vpin_tpu.spark.sparse_mlpoly import AddrTimestamps as JAddrTimestamps
from vpin_tpu.spark.sparse_mlpoly import (
    SparseMatPolyCommitmentGens as JSparseGens,
)
from vpin_tpu.sumcheck.sumcheck import SumcheckInstanceProof as JSumcheck
from vpin_tpu.transcript.merlin import Transcript as JTranscript
from vpin_tpu_torch import convert
from vpin_tpu_torch.field import FQ
from vpin_tpu_torch.field.prime_field import L_MODULUS as L
from vpin_tpu_torch.gadgets import (
    point_addition, point_addition_gadget, point_mult, point_mult_gadget,
)
from vpin_tpu_torch.poly import dense
from vpin_tpu_torch.poly.dense import DensePoly, eq_evals_host
from vpin_tpu_torch.snark import (
    SNARKGens, cp_commit_witness, cp_snark_prove, cp_snark_verify,
    snark_encode,
)
from vpin_tpu_torch.spark import (
    AddrTimestamps, BatchedDotProducts, BatchedProductCircuits,
    ProductCircuitEvalProofBatched, SparseMatPolyCommitmentGens,
    SparseMatPolyEvalProof, multi_commit,
)
from vpin_tpu_torch.sumcheck import SumcheckInstanceProof
from vpin_tpu_torch.transcript import RandomTape, Transcript
from vpin_tpu_torch.utils.bincode import deserialize_snark, serialize_snark

from test_torch_snark import add_fixture_trace, mult_fixture_trace

GOLDEN = Path(__file__).resolve().parent.parent / "crosscheck" / "golden"
ROUTES = ["default", "tensor"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def set_route(monkeypatch, route):
    """The tensor route: every table a Montgomery tensor, the witness too."""
    if route == "tensor":
        monkeypatch.setattr(dense, "HOST_POLY_MAX", 0)
        monkeypatch.setattr(point_addition, "DEVICE_WITNESS_THRESHOLD", 0)
        monkeypatch.setattr(point_mult, "DEVICE_WITNESS_THRESHOLD", 0)


def _ints(rng, n):
    return [rng.randrange(L) for _ in range(n)]


def _log(t):
    return [list(x) for x in t]


# ----------------------------------------------------------------------
# memory-checking timestamps and the matrices' commitment
# ----------------------------------------------------------------------

@pytest.mark.parametrize("num_cells,num_ops", [(64, 256), (1024, 128)])
def test_addr_timestamps_equal_vpin_tpu(num_cells, num_ops):
    rs = np.random.RandomState(num_cells)
    addrs = [rs.randint(0, num_cells, size=num_ops) for _ in range(3)]
    addrs[2][:] = 5                            # one cell read by every op
    got = AddrTimestamps(num_cells, num_ops, addrs)
    want = JAddrTimestamps(num_cells, num_ops, addrs)
    assert all(np.array_equal(a, b) for a, b in zip(got.read_ts, want.read_ts))
    assert np.array_equal(got.audit_ts, want.audit_ts)
    assert got.audit_ts.sum() == 3 * num_ops
    # a read sees the cell's count of earlier ops, over all three vectors
    seen = np.zeros(num_cells, dtype=np.int64)
    for addr, ts in zip(addrs, got.read_ts):
        for a, t in zip(addr, ts):
            assert t == seen[a]
            seen[a] += 1


def _spark_mats(seed):
    """tests/test_spark.py's shapes: three 16 x 32 matrices, 16 entries."""
    rng = random.Random(seed)
    mats = []
    for _ in range(3):
        entries = [(rng.randrange(16), rng.randrange(32), rng.randrange(L))
                   for _ in range(16)]
        mats.append(JSparseMat(entries, 16, 32))
    return mats


@pytest.mark.parametrize("route", ROUTES)
def test_multi_commit_equals_vpin_tpu(route, monkeypatch):
    jmats = _spark_mats(3)
    jcomm, jdense = jmulti_commit(jmats, 4, 5,
                                  JSparseGens(b"gens_sparse_ops", 4, 5, 16))
    set_route(monkeypatch, route)
    mats = [convert.sparse_mat_from_jax(m) for m in jmats]
    comm, dn = multi_commit(mats, 4, 5, SparseMatPolyCommitmentGens(
        b"gens_sparse_ops", 4, 5, 16), device="cpu")
    assert not dn.comb_ops.is_host and jdense.host
    assert (comm.batch_size, comm.num_ops, comm.num_mem_cells) == (
        jcomm.batch_size, jcomm.num_ops, jcomm.num_mem_cells) == (3, 16, 32)
    assert comm.comm_comb_ops.C == jcomm.comm_comb_ops.C
    assert comm.comm_comb_mem.C == jcomm.comm_comb_mem.C
    for poly, jpoly in ((dn.comb_ops, jdense.comb_ops),
                        (dn.comb_mem, jdense.comb_mem)):
        assert [int(v) for v in FQ.from_mont(poly.Z)] == jpoly.Zh


@pytest.mark.parametrize("route", ROUTES)
def test_sparse_eval_proof_roundtrip(route, monkeypatch):
    """reference sparse_mlpoly.rs check_sparse_polyeval_proof at
    tests/test_spark.py's shapes: prove, verify, reject a wrong eval."""
    set_route(monkeypatch, route)
    mats = [convert.sparse_mat_from_jax(m) for m in _spark_mats(4)]
    gens = SparseMatPolyCommitmentGens(b"gens_sparse_ops", 4, 5, 16)
    comm, dn = multi_commit(mats, 4, 5, gens, device="cpu")
    rng = random.Random(5)
    rx, ry = _ints(rng, 4), _ints(rng, 5)
    eq_rx, eq_ry = eq_evals_host(rx), eq_evals_host(ry)
    evals = [m.evaluate_host(eq_rx, eq_ry) for m in mats]
    proof = SparseMatPolyEvalProof.prove(dn, rx, ry, evals, gens,
                                         Transcript(b"example"),
                                         RandomTape(b"proof", seed=1))
    assert proof.verify(comm, rx, ry, evals, gens, Transcript(b"example"))
    bad = [(evals[0] + 1) % L] + evals[1:]
    assert proof.verify(comm, rx, ry, bad, gens, Transcript(b"example")) \
        is False


# ----------------------------------------------------------------------
# sumchecks and product circuits against vpin_tpu
# ----------------------------------------------------------------------

@pytest.mark.parametrize("route", ["host", "tensor"])
def test_sumcheck_prove_cubic_equals_vpin_tpu(route):
    rng = random.Random(11)
    tabs = [_ints(rng, 64) for _ in range(3)]
    claim = sum(a * b % L * c for a, b, c in zip(*tabs)) % L
    jt, t = JTranscript(b"sc", log=[]), Transcript(b"sc", log=[])
    jproof, jr, jclaims = JSumcheck.prove_cubic(
        claim, 6, *(JDensePoly(list(x)) for x in tabs), jt)
    polys = [DensePoly(list(x)) if route == "host"
             else DensePoly(FQ.to_mont(x, "cpu")) for x in tabs]
    proof, r, claims = SumcheckInstanceProof.prove_cubic(claim, 6, *polys, t)
    assert (proof.compressed_polys, r, claims) == \
        (jproof.compressed_polys, jr, jclaims)
    assert _log(t.log) == _log(jt.log)
    e, rv = proof.verify(claim, 6, 3, Transcript(b"sc"))
    assert rv == r and e == claims[0] * claims[1] % L * claims[2] % L
    # a wrong claim moves the final claim; a wrong degree or count fails
    assert proof.verify(claim + 1, 6, 3, Transcript(b"sc"))[0] != e
    assert proof.verify(claim, 6, 2, Transcript(b"sc")) is None
    assert proof.verify(claim, 5, 3, Transcript(b"sc")) is None


def _host_inputs(vals, K, n):
    """vpin_tpu's host route: a (K, n) numpy object array."""
    arr = np.empty((K, n), dtype=object)
    arr[:] = np.asarray(vals, dtype=object).reshape(K, n)
    return arr


@pytest.mark.parametrize("K,n,K2", [(4, 16, 2), (12, 32, 6)],
                         ids=["4x16", "12x32"])
def test_product_circuit_proof_equals_vpin_tpu(K, n, K2):
    """K n-leaf product circuits with K2 dot products of n/2 entries bound
    into their last layer (12 x 32 and 6 as SPARK stacks its ops circuits):
    evaluations, proof fields, challenges and the verifiers' outputs equal
    vpin_tpu's."""
    rng = random.Random(12 + K)
    leaves = _ints(rng, K * n)
    dots = [_ints(rng, K2 * n // 2) for _ in range(3)]
    jprod = JProductCircuits(_host_inputs(leaves, K, n))
    jdotp = JDotProducts(*(_host_inputs(d, K2, n // 2) for d in dots))
    prod = BatchedProductCircuits(FQ.to_mont(leaves, "cpu").reshape(K, n, 8))
    dotp = BatchedDotProducts(*(FQ.to_mont(d, "cpu").reshape(K2, n // 2, 8)
                                for d in dots))
    assert prod.evaluate() == jprod.evaluate()
    assert dotp.evaluate() == jdotp.evaluate()

    jt, t = JTranscript(b"pc", log=[]), Transcript(b"pc", log=[])
    jproof, jrand = JProductProof.prove(jprod, jdotp, jt)
    proof, rand = ProductCircuitEvalProofBatched.prove(prod, dotp, t)
    assert rand == jrand and _log(t.log) == _log(jt.log)
    assert proof.claims_dotp == tuple(jproof.claims_dotp)
    assert [(lp.compressed_polys, lp.claims_prod_left, lp.claims_prod_right)
            for lp in proof.proof] == \
        [(lp.compressed_polys, lp.claims_prod_left, lp.claims_prod_right)
         for lp in jproof.proof]

    claims_dotp = dotp.evaluate()
    got = proof.verify(prod.evaluate(), claims_dotp, n, Transcript(b"pc"))
    want = jproof.verify(jprod.evaluate(), claims_dotp, n, JTranscript(b"pc"))
    assert got is not None and got == tuple(want)
    assert got[2] == rand
    bad = [(prod.evaluate()[0] + 1) % L] + prod.evaluate()[1:]
    assert proof.verify(bad, claims_dotp, n, Transcript(b"pc")) is None


# ----------------------------------------------------------------------
# the full SNARK on the golden fixtures
# ----------------------------------------------------------------------

def replay_full(gadget, fname):
    """Prove and verify a fixture with the eval proof, tape seed 11, and
    hold both challenge streams and the proof bytes against the golden
    file."""
    golden = json.loads((GOLDEN / fname).read_text())
    inst, vp, vi, vf, inputs, nc, nv, ni, nnz = gadget
    gens = SNARKGens(nc, nv, ni, nnz)
    comm, decomm = snark_encode(inst, gens)
    pv, cv, bv, cpc, cic = cp_commit_witness(vp, vi, vf, gens, tape_seed=11,
                                             device="cpu")
    plog, vlog = [], []
    proof = cp_snark_prove(inst, vf, inputs, gens,
                           Transcript(b"snark_example", log=plog), pv, cv, bv,
                           decomm=decomm, tape_seed=11, with_eval_proof=True)
    assert cp_snark_verify(proof, inst, inputs,
                           Transcript(b"snark_example", log=vlog), gens,
                           cpc, cic, comm=comm)
    assert _log(plog) == _log(golden["prover_challenges"])
    assert _log(vlog) == _log(golden["verifier_challenges"])
    blob = serialize_snark(proof)
    assert blob.hex() == golden["proof_hex"]
    return blob, decomm, (inst, inputs, gens, cpc, cic, comm)


@pytest.mark.parametrize("route", ROUTES)
def test_point_add_full_snark_golden_fixture_replays(route, monkeypatch):
    set_route(monkeypatch, route)
    gadget = point_addition_gadget(*add_fixture_trace(), device="cpu")
    blob, decomm, ctx = replay_full(
        gadget, "point_add_cp_full_snark_challenges.json")
    inst, inputs, gens, cpc, cic, comm = ctx
    assert len(blob) == 16880 and not decomm.comb_ops.is_host

    def verify(proof, **kw):
        return cp_snark_verify(proof, inst, inputs,
                               Transcript(b"snark_example"), gens, cpc, cic,
                               **kw)

    back = deserialize_snark(blob)
    assert serialize_snark(back) == blob and verify(back, comm=comm)
    bad = deserialize_snark(blob)
    bad.inst_evals = ((bad.inst_evals[0] + 1) % L,) + bad.inst_evals[1:]
    assert not verify(bad, comm=comm)
    # no mode is taken for another: an eval proof needs the commitment, and
    # a verifier holding one needs an eval proof
    assert not verify(back)
    transparent = deserialize_snark(blob)
    transparent.r1cs_eval_proof = None
    assert not verify(transparent, comm=comm)
    with pytest.raises(ValueError):
        deserialize_snark(blob + b"\x00")
    with pytest.raises(ValueError):
        deserialize_snark(blob[:-1])


# the 2-mult witness scan (10^5 serial K1 calls, 100+ s on one CPU thread),
# then SPARK over 2^14 nonzeros on the tensor route
@pytest.mark.slow
def test_point_mult_full_snark_golden_fixture_replays():
    gadget = point_mult_gadget(*mult_fixture_trace(), n=128, device="cpu")
    blob, decomm, _ = replay_full(
        gadget, "point_mult_cp_full_snark_challenges.json")
    assert len(blob) == 58256 and not decomm.comb_ops.is_host
