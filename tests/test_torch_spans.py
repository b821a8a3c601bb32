"""The port's phase spans (utils/timer.span) inside the SPARK eval proof,
the rLC layers and the client's ElGamal, and the benchmark's readers of
them, on the CPU.

Tolerance: exact.  With RECORD on, the 2-add full-SNARK golden fixture
still proves to its bytes and the served outputs and traces equal those of
a run with RECORD off; each span is recorded under the parent it tiles
(the serving parents wrapped in spans here, as a traced benchmark run
wraps them in profiler annotations), and the children's seconds stay
within the parent's.
"""

import random

import numpy as np
import pytest
import torch

from benchmark import cells
from vpin_tpu_torch.gadgets import point_addition_gadget
from vpin_tpu_torch.nn import models
from vpin_tpu_torch.nn.bsgs import BsgsTable
from vpin_tpu_torch.nn.elgamal import KeyPair
from vpin_tpu_torch.nn.homomorphic import HomomorphicEngine
from vpin_tpu_torch.utils import timer

from test_torch_models import host_cache, rlc_keys, tiny_weights
from test_torch_snark import add_fixture_trace
from test_torch_spark import replay_full

SPARK = ("spark_derefs", "spark_layers", "spark_prod_sumcheck",
         "spark_hash_layer")
RLC = ("layer_products", "rlc_scalars", "rlc_left", "rlc_right")
#: the parents a traced run names, and the spans that tile each
CHILDREN = {
    "conv2d": RLC,
    "fc": RLC,
    "decrypt_batch": ("decrypt_ladder", "bsgs_search", "bsgs_verify"),
    "encrypt_batch": ("encrypt_nonces", "encrypt_tables"),
}


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


def parents(record):
    """(label, parent label or None) of each recorded span.  RECORD holds
    spans in the order they stop, so a span's parent is the first span
    after it that sits one level up."""
    out = []
    for i, (depth, label, _, _) in enumerate(record):
        up = next((r for r in record[i + 1:] if r[0] < depth), None)
        out.append((label, up[1] if up else None))
    return out


def test_spark_spans_tile_the_eval_proof(monkeypatch):
    monkeypatch.setattr(timer, "RECORD", [])
    gadget = point_addition_gadget(*add_fixture_trace(), device="cpu")
    # the proof's bytes and both challenge streams equal the golden file's
    replay_full(gadget, "point_add_cp_full_snark_challenges.json")
    record = timer.RECORD
    parent, = [r for r in record if r[1] == "R1CSEvalProof::prove"]
    ups = dict(parents(record))
    for label in SPARK:
        mine = [r for r in record if r[1] == label]
        assert len(mine) == 1, label
        assert mine[0][0] == parent[0] + 1 and ups[label] == parent[1]
    assert sum(r[2] for r in record if r[1] in SPARK) <= parent[2]


def _wrap(monkeypatch):
    """Open a span around each serving parent, where a traced benchmark
    run opens a profiler annotation."""
    def named(fn, label):
        def wrapper(*args, **kwargs):
            with timer.span(label):
                return fn(*args, **kwargs)
        return wrapper
    for owner, name in ((models, "encrypt_batch"), (models, "decrypt_batch"),
                        (HomomorphicEngine, "conv2d"),
                        (HomomorphicEngine, "fc")):
        monkeypatch.setattr(owner, name, named(getattr(owner, name), name))


def _image(size):
    return np.random.default_rng(7).integers(0, 256, (size, size))


def _conv(key):
    return models.run_conv_workload(_image(4), 3, key, random.Random(3),
                                    key_source=rlc_keys())


def _cnn(key, table):
    """CNN A on a 4x4 image, as test_torch_models.py's CLI case runs it:
    the table at m = 2^18 and 2,048 giant steps."""
    return models.run_cnn_workload("A", _image(4), key, table,
                                   weights=tiny_weights(1, 16),
                                   rng=random.Random(3), max_steps=2048,
                                   key_source=rlc_keys())


def _points_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _traces_equal(a, b):
    fa, fb = a.finalize(), b.finalize()
    return fa.keys() == fb.keys() and all(
        np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def _check_nesting(record, parents_run):
    ups = parents(record)
    seen = {label for label, _ in ups}
    by_parent = {}
    for label, up in ups:
        if up in CHILDREN:
            assert label in CHILDREN[up], (label, up)
            by_parent.setdefault(up, set()).add(label)
    for parent in parents_run:
        assert parent in seen
        assert by_parent[parent] == set(CHILDREN[parent]), parent
    # the children's seconds stay within each parent's
    for i, (depth, label, secs, _) in enumerate(record):
        if label not in parents_run:
            continue
        kids = 0.0
        for d, _, s, _ in reversed(record[:i]):
            if d <= depth:
                break
            if d == depth + 1:
                kids += s
        assert kids <= secs, label


def test_serving_spans_nest_and_change_nothing(monkeypatch, keypair,
                                              tmp_path):
    cache = tmp_path / "t.pkl"
    host_cache(cache, 1 << 18)
    table = BsgsTable.build(1 << 18, cache_path=str(cache), device="cpu")
    plain_conv, plain_cnn = _conv(keypair), _cnn(keypair, table)

    _wrap(monkeypatch)
    monkeypatch.setattr(timer, "RECORD", [])
    conv = _conv(keypair)
    _check_nesting(timer.RECORD, ("encrypt_batch", "conv2d"))
    assert sum(r[1] == "conv2d" for r in timer.RECORD) == 2
    monkeypatch.setattr(timer, "RECORD", [])
    cnn = _cnn(keypair, table)
    _check_nesting(timer.RECORD, tuple(CHILDREN))
    # two fc halves a layer, each with its two rlc_scalars
    assert sum(r[1] == "fc" for r in timer.RECORD) == 4
    assert sum(r[1] == "rlc_scalars" for r in timer.RECORD) == 2 + 4 * 2

    assert _points_equal(conv.ciphertext.c1, plain_conv.ciphertext.c1)
    assert _points_equal(conv.ciphertext.c2, plain_conv.ciphertext.c2)
    for h, p in zip(conv.outputs, plain_conv.outputs):
        assert _points_equal(h, p)
    assert _traces_equal(conv.trace, plain_conv.trace)
    assert np.array_equal(cnn.logits, plain_cnn.logits)
    assert cnn.decrypt_rounds == plain_cnn.decrypt_rounds
    assert _traces_equal(cnn.trace, plain_cnn.trace)


READERS = {
    "spark_derefs_ms": ("proof", "spark_derefs"),
    "spark_layers_ms": ("proof", "spark_layers"),
    "spark_prod_sumcheck_ms": ("proof", "spark_prod_sumcheck"),
    "spark_hash_layer_ms": ("proof", "spark_hash_layer"),
    "rlc_scalars_ms": ("serve", "rlc_scalars"),
    "bsgs_search_ms": ("serve", "bsgs_search"),
    "encrypt_nonces_ms": ("serve", "encrypt_nonces"),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_reader(metric):
    kind, label = READERS[metric]
    read = cells.reader(metric)

    def rec(spans, kind=kind):
        steps = [{"ok": True, "profiled": False, "latency_s": 1.0,
                  "spans": dict(s)} for s in spans]
        return {"kind": kind, "steps": steps}

    with_spans = rec([{label: 0.25, "other": 9.0}, {label: 0.5}])
    assert read(with_spans) == pytest.approx(375.0)
    assert read(rec([{"other": 9.0}, {"other": 1.0}])) is None
    assert read(rec([])) is None
    other = "serve" if kind == "proof" else "proof"
    assert read(rec([{label: 0.25}], kind=other)) is None
