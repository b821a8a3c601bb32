"""The sumchecks' round sums and binds (vpin_tpu_torch/sumcheck) on the CPU,
where round_sums_split and bind_tables run their plain versions, the
yardsticks of csrc/sumcheck.cu's sc_round and sc_bind: held against exact
host arithmetic mod l for every kind, K stacked instances and half length,
with an eq table broadcast along K, and with the chunk loops running.  The
kernels' wrappers (sumcheck/cuda_sumcheck.py) are held to what they refuse
and to how they lay the tables out for the kernel.

Tolerance: exact (canonical ints mod l).
"""

import numpy as np
import pytest
import torch

from vpin_tpu_torch import kernels
from vpin_tpu_torch.field import FQ
from vpin_tpu_torch.field.prime_field import L_MODULUS as L
from vpin_tpu_torch.poly.dense import eq_evals, eq_evals_host
from vpin_tpu_torch.sumcheck import cuda_sumcheck, sumcheck
from vpin_tpu_torch.sumcheck.sumcheck import (bind_tables, round_evals_host,
                                              round_sums, round_sums_split)

RS = np.random.RandomState(16)
TABLES = {"quad": 2, "cubic": 3, "cubic_additive": 4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small ops, where torch's intra-op
    threads cost more than they give under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(n):
    """n field elements: 0, 1 and l - 1 first, then uniform ones."""
    vals = [int.from_bytes(RS.bytes(32), "little") % L for _ in range(n)]
    return ([0, 1, L - 1] + vals[3:])[:n]


def _tables(K, h, count):
    """count tables of K instances of 2h elements: host int rows and the
    (K, 2h, 8) Montgomery stack, or (2h, 8) for K = None."""
    rows = [[_ints(2 * h) for _ in range(K or 1)] for _ in range(count)]
    dev = [FQ.to_mont(r, "cpu") for r in rows]
    return rows, dev if K else [t[0] for t in dev]


def _sums(t):
    """Montgomery sums (points, K, 8) or (points, 8) -> host ints
    (points, K)."""
    ints = FQ.from_mont(t)
    return [[int(v) for v in np.atleast_1d(row)] for row in ints]


def _host_bind(row, r):
    n = len(row) // 2
    return [(lo + r * (hi - lo)) % L for lo, hi in zip(row[:n], row[n:])]


@pytest.mark.parametrize("h", [1, 16, 1 << 11])
@pytest.mark.parametrize("K", [None, 1, 4, 12])
@pytest.mark.parametrize("kind", sorted(TABLES))
def test_round_sums_equal_host(kind, K, h):
    """Every kind over K stacked instances (None: one unstacked table, the
    sat proof's layout) and halves of 1 to 2^11, against round_evals_host
    instance by instance."""
    rows, tabs = _tables(K, h, TABLES[kind])
    got = _sums(round_sums(kind, tabs))
    want = [round_evals_host(kind, [t[k] for t in rows])
            for k in range(K or 1)]
    assert got == [list(p) for p in zip(*want)]


@pytest.mark.parametrize("h", [1, 16, 1 << 11])
@pytest.mark.parametrize("K", [None, 4, 12])
@pytest.mark.parametrize("count", [2, 3, 4])
def test_bind_tables_equal_host(count, K, h):
    rows, tabs = _tables(K, h, count)
    r = _ints(4)[3]
    bound = bind_tables(tabs, r)
    assert len(bound) == count
    for b, row in zip(bound, rows):
        assert b.shape == ((K,) if K else ()) + (h, 8)
        got = [[int(v) for v in FQ.from_mont(b).reshape(-1)]]
        want = [sum((_host_bind(row[k], r) for k in range(K or 1)), [])]
        assert got == want


def test_eq_table_broadcast_along_instances():
    """The product circuits' layout: A and B the halves of a stored layer
    (views of one stack), C the eq table expanded along K (stride 0); the
    round sums and the bind equal the host's on the materialised tables."""
    K, h = 12, 1 << 5
    rows = [_ints(4 * h) for _ in range(K)]
    stack = FQ.to_mont(rows, "cpu")                        # (K, 4h, 8)
    A, B = stack[:, :2 * h], stack[:, 2 * h:]
    rand = _ints(7)[1:]                                     # 6 variables
    C = eq_evals(rand, "cpu").expand(A.shape)
    assert C.stride(0) == 0
    eq = eq_evals_host(rand)
    hostA = [r[:2 * h] for r in rows]
    hostB = [r[2 * h:] for r in rows]
    got = _sums(round_sums("cubic", [A, B, C]))
    want = [round_evals_host("cubic", [hostA[k], hostB[k], eq])
            for k in range(K)]
    assert got == [list(p) for p in zip(*want)]
    r = _ints(5)[4]
    bA, bB, bC = bind_tables([A, B, C], r)
    assert bC.shape == (K, h, 8)
    for bound, host in ((bA, hostA), (bB, hostB), (bC, [eq] * K)):
        assert [[int(v) for v in row] for row in FQ.from_mont(bound)] == \
            [_host_bind(x, r) for x in host]


@pytest.mark.parametrize("kind", sorted(TABLES))
def test_chunk_loops(kind, monkeypatch):
    """ROUND_CHUNK_ELEMS lowered: the rounds and binds run in chunks of the
    half axis (each chunk's round adding the sums so far), and equal the
    whole tables' host sums and binds."""
    K, h = 4, 64
    rows, tabs = _tables(K, h, TABLES[kind])
    monkeypatch.setattr(sumcheck, "ROUND_CHUNK_ELEMS", 32)
    calls = []

    def spy(kind_, los, his, acc=None):
        calls.append((los[0].shape[-2], acc is not None))
        return round_sums_split(kind_, los, his, acc)

    monkeypatch.setattr(sumcheck, "round_sums_split", spy)
    got = _sums(round_sums(kind, tabs))
    assert calls == [(8, False)] + [(8, True)] * 7       # 32 / K a chunk
    want = [round_evals_host(kind, [t[k] for t in rows]) for k in range(K)]
    assert got == [list(p) for p in zip(*want)]
    r = _ints(4)[3]
    for b, row in zip(bind_tables(tabs, r), rows):
        assert [[int(v) for v in x] for x in FQ.from_mont(b)] == \
            [_host_bind(row[k], r) for k in range(K)]


def test_plain_path_launches_nothing():
    """CPU tensors take the plain versions; the kernels' launch counters
    exist and stay as they were."""
    assert kernels.ENTRIES["sc_round"][0] == "sumcheck"
    assert kernels.ENTRIES["sc_bind"][0] == "sumcheck"
    assert kernels.SOURCES["sumcheck"] == "sumcheck.cu"
    before = dict(kernels.LAUNCHES)
    assert "sc_round" in before and "sc_bind" in before
    _, tabs = _tables(2, 8, 3)
    round_sums("cubic", tabs)
    bind_tables(tabs, 5)
    assert kernels.LAUNCHES == before


def _cases():
    t = FQ.to_mont(_ints(8), "cpu").reshape(2, 4, 8)
    lo, hi = t[:, :2], t[:, 2:]
    odd = torch.zeros((2, 2, 7), dtype=torch.int32)
    return t, lo, hi, odd


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "int32"), ("limbs", ValueError, "last dim of 8"),
    ("device", ValueError, "CUDA tensors"),
    ("halves", ValueError, "different lengths"),
    ("tables", ValueError, "takes 3 tables"),
    ("kind", ValueError, "unknown round kind"),
    ("acc", ValueError, "acc of shape")])
def test_sc_round_refuses(case, error, match):
    """sc_round raises on what the kernel does not take: int64 limbs, a
    last axis other than 8, CPU tensors, halves of different lengths, the
    wrong number of tables for the kind, an unknown kind, an acc of another
    shape."""
    _, lo, hi, odd = _cases()
    kind, los, his, acc = "quad", [lo, lo], [hi, hi], None
    if case == "dtype":
        los = [lo.long(), lo]
    elif case == "limbs":
        los = [odd, lo]
    elif case == "halves":
        his = [hi, hi[:, :1]]
    elif case == "tables":
        kind = "cubic"
    elif case == "kind":
        kind = "quartic"
    elif case == "acc":
        acc = torch.zeros((3, 2, 8), dtype=torch.int32)
    with pytest.raises(error, match=match):
        cuda_sumcheck.sc_round(kind, los, his, acc)


@pytest.mark.parametrize("case,error,match", [
    ("dtype", TypeError, "int32"), ("device", ValueError, "CUDA tensors"),
    ("shapes", ValueError, "different shapes"),
    ("out", ValueError, "out of shape"), ("tables", ValueError, "1 to 4")])
def test_sc_bind_refuses(case, error, match):
    """sc_bind raises on int64 limbs, CPU tensors, halves of different
    shapes, an out of another shape, and more tables than one launch
    binds."""
    _, lo, hi, _ = _cases()
    los, his = [lo, lo], [hi, hi]
    out = torch.empty((2,) + tuple(lo.shape), dtype=torch.int32)
    if case == "dtype":
        out = out.long()
    elif case == "shapes":
        his = [hi, hi[:1]]
    elif case == "out":
        out = out[:1]
    elif case == "tables":
        n = cuda_sumcheck.MAX_TABLES + 1
        los, his = [lo] * n, [hi] * n
        out = torch.empty((n,) + tuple(lo.shape), dtype=torch.int32)
    with pytest.raises(error, match=match):
        cuda_sumcheck.sc_bind(los, his, 3, out)


def test_tables_are_read_through_their_strides():
    """The layout the kernels get: a layer's halves and an eq table
    expanded along K are views of their storage (stride 0 along K for the
    eq table), an unstacked table is one instance, and each descriptor
    carries its halves' addresses and word strides."""
    K, h = 3, 4
    stack = FQ.to_mont([_ints(4 * h) for _ in range(K)], "cpu")
    A = stack[:, :2 * h]
    C = eq_evals(_ints(4)[1:], "cpu").expand(A.shape)
    lead = A.shape[:-2]
    a = cuda_sumcheck._instances("t", A[:, :h], lead)
    c = cuda_sumcheck._instances("t", C[:, h:], lead)
    assert a.data_ptr() == stack.data_ptr() and a.stride() == (32 * h, 8, 1)
    assert c.stride() == (0, 8, 1) and c.data_ptr() == C.data_ptr() + 32 * h
    one = cuda_sumcheck._instances("t", A[0], torch.Size())
    assert one.shape == (1, 2 * h, 8)
    desc = list(cuda_sumcheck._desc([a, one], [c, one]))
    assert desc == [a.data_ptr(), c.data_ptr(), 32 * h, 8, 0, 8,
                    one.data_ptr(), one.data_ptr(), 0, 8, 0, 8]
    with pytest.raises(ValueError):                 # limbs not contiguous
        cuda_sumcheck._instances("t", stack.transpose(1, 2)[..., :8],
                                 lead)


@pytest.mark.parametrize("K,h,blocks", [
    (1, 1, 1), (12, 512, 1), (12, 513, 2), (12, 2048, 4), (1, 1 << 21, 1024),
    (12, 1 << 17, 85), (2000, 1 << 10, 1)])
def test_round_blocks(K, h, blocks):
    """One block an instance for every 512 elements of the half (256
    threads, 2 elements each), at most 1,024 blocks over all, at least
    one."""
    assert cuda_sumcheck.round_blocks(K, h) == blocks
