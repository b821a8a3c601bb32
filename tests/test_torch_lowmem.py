"""The SPARK prover's memory bounding against vpin_tpu, every threshold and
chunk forced small on both packages: lazy product-tree layers
(LOW_MEMORY_ELEMS), chunked sumcheck rounds and binds (ROUND_CHUNK_ELEMS),
chunked
hashed leaves written into the ops circuits' input (_LEAF_CHUNK), chunked
R1CS reductions and evaluation (SparseMat.REDUCE_CHUNK_ELEMS, evaluate's
``chunk``), chunked bound_L and Hyrax digits.  Each mode gives the same
values, proofs and transcripts as the unforced port and as vpin_tpu, and
the 2-add full-SNARK golden fixture replays byte for byte with every mode
forced.  vpin_tpu's product circuits take a jnp input here, so that its
device route, and with it its lazy mode, runs.
"""

import random

import numpy as np
import pytest
import torch

from vpin_tpu.field.prime_field import FQ as JFQ
from vpin_tpu.poly.dense import DensePoly as JDensePoly
from vpin_tpu.snark.r1cs import SparseMat as JSparseMat
from vpin_tpu.snark.r1csproof import PolyCommitmentGens as JPolyGens
from vpin_tpu.snark.r1csproof import poly_commit as jpoly_commit
from vpin_tpu.spark import product_tree as jpt
from vpin_tpu.spark import sparse_mlpoly as jsm
from vpin_tpu.transcript.merlin import Transcript as JTranscript
from vpin_tpu_torch import convert
from vpin_tpu_torch.commit import pedersen
from vpin_tpu_torch.field import FQ
from vpin_tpu_torch.field.prime_field import L_MODULUS as L
from vpin_tpu_torch.gadgets import point_addition_gadget
from vpin_tpu_torch.poly import dense
from vpin_tpu_torch.poly.dense import DensePoly, eq_evals, eq_evals_host
from vpin_tpu_torch.snark import r1cs
from vpin_tpu_torch.snark.r1csproof import PolyCommitmentGens, poly_commit
from vpin_tpu_torch.spark import product_tree as pt
from vpin_tpu_torch.spark import sparse_mlpoly as sm
from vpin_tpu_torch.sumcheck import sumcheck
from vpin_tpu_torch.transcript import Transcript

from test_torch_snark import add_fixture_trace
from test_torch_spark import replay_full, set_route


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def field_ints(rs: np.random.RandomState, n: int):
    return [int.from_bytes(rs.bytes(32), "little") % L for _ in range(n)]


def port_ints(t: torch.Tensor):
    return [int(v) for v in FQ.from_mont(t).reshape(-1)]


def jax_ints(a):
    return [int(v) for v in JFQ.from_mont(a).reshape(-1)]


def _log(t):
    return [list(x) for x in t]


# ----------------------------------------------------------------------
# product circuits: 12 circuits of 32 leaves and 6 dot products, SPARK's
# stacking
# ----------------------------------------------------------------------

K, N, K2 = 12, 32, 6


@pytest.fixture(scope="module")
def circuit_inputs():
    rs = np.random.RandomState(21)
    return field_ints(rs, K * N), [field_ints(rs, K2 * N // 2)
                                   for _ in range(3)]


def prove_port(leaves, dots):
    prod = pt.BatchedProductCircuits(FQ.to_mont(leaves, "cpu").reshape(
        K, N, 8))
    dotp = pt.BatchedDotProducts(*(FQ.to_mont(d, "cpu").reshape(
        K2, N // 2, 8) for d in dots))
    t = Transcript(b"pc", log=[])
    proof, rand = pt.ProductCircuitEvalProofBatched.prove(prod, dotp, t)
    return prod, proof, rand, _log(t.log)


def proof_fields(proof):
    return ([(lp.compressed_polys, lp.claims_prod_left, lp.claims_prod_right)
             for lp in proof.proof], tuple(proof.claims_dotp))


@pytest.fixture(scope="module")
def jax_lazy_proof(circuit_inputs):
    """vpin_tpu's proof on its device route with every circuit lazy."""
    leaves, dots = circuit_inputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpt, "LOW_MEMORY_ELEMS", 0)
        jprod = jpt.BatchedProductCircuits(
            JFQ.to_mont(leaves).reshape(K, N, 16))
        jdotp = jpt.BatchedDotProducts(*(JFQ.to_mont(d).reshape(
            K2, N // 2, 16) for d in dots))
        assert jprod.low_memory
        evals = jprod.evaluate()
        jt = JTranscript(b"pc", log=[])
        jproof, jrand = jpt.ProductCircuitEvalProofBatched.prove(
            jprod, jdotp, jt)
    return evals, proof_fields(jproof), jrand, _log(jt.log)


@pytest.mark.parametrize("mode", ["stored", "lazy", "lazy_chunked"])
def test_product_circuit_proof_equals_vpin_tpu_lazy(mode, circuit_inputs,
                                                    jax_lazy_proof,
                                                    monkeypatch):
    """Stored, lazy, and lazy with rounds and binds in chunks of one and two
    positions: evaluations, proof fields, challenges and transcript equal
    vpin_tpu's lazy proof, and the proof verifies."""
    if mode != "stored":
        monkeypatch.setattr(pt, "LOW_MEMORY_ELEMS", 0)
    if mode == "lazy_chunked":
        monkeypatch.setattr(sumcheck, "ROUND_CHUNK_ELEMS", 12)
    prod, proof, rand, log = prove_port(*circuit_inputs)
    assert prod.low_memory == (mode != "stored")
    evals, fields, jrand, jlog = jax_lazy_proof
    assert prod.evaluate() == evals
    assert proof_fields(proof) == fields
    assert rand == jrand and log == jlog
    dots = circuit_inputs[1]
    claims_dotp = pt.BatchedDotProducts(*(FQ.to_mont(d, "cpu").reshape(
        K2, N // 2, 8) for d in dots)).evaluate()
    got = proof.verify(evals, claims_dotp, N, Transcript(b"pc"))
    assert got is not None and got[2] == rand


def test_lazy_layers_equal_stored_layers(circuit_inputs, monkeypatch):
    leaves = FQ.to_mont(circuit_inputs[0], "cpu").reshape(K, N, 8)
    stored = pt.BatchedProductCircuits(leaves)
    monkeypatch.setattr(pt, "LOW_MEMORY_ELEMS", K * N - 1)
    lazy = pt.BatchedProductCircuits(leaves)
    assert lazy.low_memory and not stored.low_memory
    assert not hasattr(lazy, "layers")
    assert lazy.num_layers == stored.num_layers == 5
    for i in range(stored.num_layers):
        for got, want in zip(lazy.layer(i), stored.layer(i)):
            assert torch.equal(got, want)
    assert lazy.evaluate() == stored.evaluate()
    # one circuit over the threshold's edge: K * N == LOW_MEMORY_ELEMS stays
    monkeypatch.setattr(pt, "LOW_MEMORY_ELEMS", K * N)
    assert not pt.BatchedProductCircuits(leaves).low_memory


# ----------------------------------------------------------------------
# hashed leaves
# ----------------------------------------------------------------------

CELLS, OPS = 64, 100


@pytest.fixture(scope="module")
def leaf_inputs():
    rs = np.random.RandomState(22)
    addrs = [rs.randint(0, CELLS, size=OPS) for _ in range(3)]
    table = field_ints(rs, CELLS)
    vals = [field_ints(rs, OPS) for _ in range(3)]
    r_mem = tuple(field_ints(rs, 2))
    jts = jsm.AddrTimestamps(CELLS, OPS, addrs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsm, "_LEAF_CHUNK", 16)
        jl = jsm.Layers(JFQ.to_mont(table), jts,
                        [JFQ.to_mont(v) for v in vals], r_mem)
    want = [jax_ints(x) for x in [jl.init_leaves, jl.audit_leaves]
            + jl.read_leaves + jl.write_leaves]
    return addrs, table, vals, r_mem, want


@pytest.mark.parametrize("chunk", [None, 16, 7, 1])
def test_chunked_leaves_equal_vpin_tpu(chunk, leaf_inputs, monkeypatch):
    """init, audit, reads and writes (chunks of 16 on vpin_tpu's side;
    the port's unchunked, in chunks of 16, of 7 with a ragged last chunk,
    and of 1), the ops leaves written into the rows the caller gave."""
    addrs, table, vals, r_mem, want = leaf_inputs
    if chunk is not None:
        monkeypatch.setattr(sm, "_LEAF_CHUNK", chunk)
    ts = sm.AddrTimestamps(CELLS, OPS, addrs)
    stack = FQ.zeros((8, OPS), "cpu")
    layers = sm.Layers(FQ.to_mont(table, "cpu"), ts,
                       [FQ.to_mont(v, "cpu") for v in vals], r_mem,
                       stack[2:])
    assert (stack[:2] == 0).all()
    got = [port_ints(layers.init_leaves), port_ints(layers.audit_leaves)] \
        + [port_ints(row) for row in stack[2:]]
    assert got == want


# ----------------------------------------------------------------------
# R1CS reductions and evaluation
# ----------------------------------------------------------------------

ROWS, COLS = 32, 64


@pytest.fixture(scope="module")
def matrix():
    """Rows of 1 to 4 nonzeros (four buckets), values from a small book and
    a few random ones, as the gadgets' matrices."""
    rs = np.random.RandomState(23)
    book = [1, L - 1, 2] + field_ints(rs, 3)
    entries = []
    for r in range(ROWS):
        for c in rs.choice(COLS, size=1 + r % 4, replace=False):
            entries.append((r, int(c), book[rs.randint(len(book))]))
    rs.shuffle(entries)
    return entries, field_ints(rs, COLS), field_ints(rs, ROWS)


@pytest.fixture(scope="module")
def jax_reductions(matrix):
    entries, z, rx = matrix
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSparseMat, "REDUCE_CHUNK_ELEMS", 8)
        jm = JSparseMat(entries, ROWS, COLS)
        mz = jax_ints(jm.multiply_vec(COLS, JFQ.to_mont(z)))
        mt = jax_ints(jm.compute_eval_table(JFQ.to_mont(rx), COLS))
    return mz, mt, jm


@pytest.mark.parametrize("chunk", [None, 8, 1])
def test_chunked_reductions_equal_vpin_tpu(chunk, matrix, jax_reductions,
                                           monkeypatch):
    """M z and M^T r, the port unchunked and in chunks of 8 and of 1 index
    elements, against vpin_tpu's chunks of 8 and the host sums."""
    entries, z, rx = matrix
    mz, mt, jm = jax_reductions
    if chunk is not None:
        monkeypatch.setattr(r1cs.SparseMat, "REDUCE_CHUNK_ELEMS", chunk)
    m = convert.sparse_mat_from_jax(jm)
    assert port_ints(m.multiply_vec(COLS, FQ.to_mont(z, "cpu"))) == mz
    assert port_ints(m.compute_eval_table(FQ.to_mont(rx, "cpu"), COLS)) == mt
    assert mz == m.multiply_vec_host(z)
    assert mt == m.compute_eval_table_host(rx, COLS)


@pytest.mark.parametrize("chunk", [None, 5, 1])
def test_chunked_evaluate_equals_vpin_tpu(chunk, matrix, jax_reductions):
    """sum val eq(rx, row) eq(ry, col) in pieces of ``chunk`` nonzeros (the
    default, 5 with a ragged last piece, 1) against vpin_tpu's pieces of 5
    and the host sum."""
    _, mt, jm = jax_reductions
    rng = random.Random(24)
    rx = [rng.randrange(L) for _ in range(5)]
    ry = [rng.randrange(L) for _ in range(6)]
    m = convert.sparse_mat_from_jax(jm)
    from vpin_tpu.poly.dense import eq_evals as jeq_evals
    want = jm.evaluate(jeq_evals(rx), jeq_evals(ry), chunk=5)
    assert want == m.evaluate_host(eq_evals_host(rx), eq_evals_host(ry))
    assert m.evaluate(eq_evals(rx, "cpu"), eq_evals(ry, "cpu"),
                      chunk=chunk) == want


# ----------------------------------------------------------------------
# the Hyrax commit's digits and bound_L in chunks
# ----------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 16, 1])
def test_chunked_hyrax_commit_and_bound_equal_vpin_tpu(chunk, monkeypatch):
    """A 2^8-entry tensor poly (16 x 16 Hyrax rows): its commitment with
    the digits made a row at a time (16) or an entry at a time (1), and
    bound_L by rows, equal vpin_tpu's."""
    rs = np.random.RandomState(25)
    vals = field_ints(rs, 1 << 8)
    L_vec = field_ints(rs, 16)
    gens = PolyCommitmentGens(8, b"lowmem")
    jcomm, _ = jpoly_commit(JDensePoly(list(vals)), JPolyGens(8, b"lowmem"),
                            None)
    jbound = JDensePoly(JFQ.to_mont(vals)).bound_L(JFQ.to_mont(L_vec))
    if chunk is not None:
        monkeypatch.setattr(pedersen, "_DIGIT_CHUNK_ELEMS", chunk)
        monkeypatch.setattr(dense, "_BOUND_CHUNK_ELEMS", chunk)
    poly = DensePoly(FQ.to_mont(vals, "cpu"))
    comm, _ = poly_commit(poly, gens, None)
    assert comm.C == jcomm.C
    assert port_ints(poly.bound_L(FQ.to_mont(L_vec, "cpu"))) == \
        jax_ints(jbound)


# ----------------------------------------------------------------------
# the 2-add full-SNARK golden fixture with every mode forced
# ----------------------------------------------------------------------

@pytest.mark.parametrize("route", ["default", "tensor"])
def test_point_add_full_snark_golden_fixture_with_every_mode_forced(
        route, monkeypatch):
    """Every product circuit lazy, the sumchecks' rounds and binds in
    chunks of 48 elements, the leaves in chunks of 5, the R1CS reductions
    and evaluation in chunks of 4, bound_L and the Hyrax digits in chunks
    of 8: the challenge streams and proof bytes equal crosscheck/golden/'s,
    and each mode ran."""
    set_route(monkeypatch, route)
    monkeypatch.setattr(pt, "LOW_MEMORY_ELEMS", 0)
    monkeypatch.setattr(sumcheck, "ROUND_CHUNK_ELEMS", 48)
    monkeypatch.setattr(sm, "_LEAF_CHUNK", 5)
    monkeypatch.setattr(r1cs.SparseMat, "REDUCE_CHUNK_ELEMS", 4)
    monkeypatch.setattr(dense, "_BOUND_CHUNK_ELEMS", 8)
    monkeypatch.setattr(pedersen, "_DIGIT_CHUNK_ELEMS", 8)
    seen = {"lazy": [], "round": 0, "leaf": set(), "reduce": 0}
    init = pt.BatchedProductCircuits.__init__

    def spy_init(self, inputs):
        init(self, inputs)
        seen["lazy"].append(self.low_memory)

    def spy(key, fn, size):
        def wrapper(*args):
            seen[key] = (seen[key] | {size(args)} if key == "leaf"
                         else max(seen[key], size(args)))
            return fn(*args)
        return wrapper

    monkeypatch.setattr(pt.BatchedProductCircuits, "__init__", spy_init)
    monkeypatch.setattr(sumcheck, "round_sums_split", spy(
        "round", sumcheck.round_sums_split,
        lambda a: a[1][0][..., 0].numel()))
    monkeypatch.setattr(sm, "small_ints_to_dev", spy(
        "leaf", sm.small_ints_to_dev, lambda a: len(a[0])))
    monkeypatch.setattr(r1cs, "regular_reduce", spy(
        "reduce", r1cs.regular_reduce, lambda a: a[1].shape[0]))

    gadget = point_addition_gadget(*add_fixture_trace(), device="cpu")
    blob, _, _ = replay_full(gadget, "point_add_cp_full_snark_challenges.json")
    assert len(blob) == 16880
    assert seen["lazy"] == [True, True]
    assert 0 < seen["round"] <= 48             # a chunk's elements a table
    assert 5 in seen["leaf"]                    # whole chunks of leaves
    if route == "tensor":                       # the host route has no reduce
        assert 0 < seen["reduce"] <= 4          # rows of a bucket's chunk
