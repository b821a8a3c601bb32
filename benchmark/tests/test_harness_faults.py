"""The comparison can fail: runs with the timed path broken underneath,
and each cell kind's control, come out as not correct.

Faults, as the benchmark's rules name them, where a cell can have them:
an answer altered where it is produced, half of the batch left out, a step
that returns its state unchanged.  No cell spans chips, so the exchange
between chips cannot be left out."""

from __future__ import annotations

import pytest

from benchmark.tests.small import run_small


def _shifted(P):
    """A point batch with its first point replaced by its double."""
    from vpin_tpu_torch.curve.weierstrass import E2, PointW
    flat = PointW(*(c.reshape(-1, c.shape[-1]).clone() for c in P))
    first = PointW(*(c[:1] for c in flat))
    d = E2.add(first, first)
    for c, v in zip(flat, d):
        c[:1] = v
    return PointW(*(c.reshape(P[0].shape) for c in flat))


def _conv_fault(monkeypatch, how):
    from vpin_tpu_torch.curve.weierstrass import E2, PointW
    from vpin_tpu_torch.nn import homomorphic
    conv2d = homomorphic.HomomorphicEngine.conv2d

    def broken(self, P, filt, key, padding=0, stride=1):
        out = conv2d(self, P, filt, key, padding=padding, stride=stride)
        if how == "altered":
            return _shifted(out)
        if how == "half":
            rows = out[0].shape[0] // 2
            inf = E2.infinity(tuple(out[0].shape[:-1]), out[0].device)
            return PointW(*(torch_cat(o[:rows], i[rows:])
                            for o, i in zip(out, inf)))
        return P                                   # "unchanged"

    monkeypatch.setattr(homomorphic.HomomorphicEngine, "conv2d", broken)


def torch_cat(a, b):
    import torch
    return torch.cat([a, b])


@pytest.mark.parametrize("how", ["altered", "half", "unchanged"])
def test_conv_faults(bench, monkeypatch, how):
    _conv_fault(monkeypatch, how)
    line = run_small(bench, "conv3.serve_256")
    assert line["correct"] is False
    assert line["checks"]["output_mismatch"]["value"] > 0


def test_cnn_answer_altered(bench, monkeypatch):
    """The logits' decryption returns every value 1,000 too high."""
    from vpin_tpu_torch.nn import models
    decrypt = models.decrypt_batch

    def broken(ct, key, table, max_steps=None):
        vals = decrypt(ct, key, table, max_steps=max_steps)
        if vals.shape == (10,):                     # the logits
            vals = vals + 1000
        return vals

    monkeypatch.setattr(models, "decrypt_batch", broken)
    line = run_small(bench, "cnn_a.serve_32")
    assert line["correct"] is False
    assert line["checks"]["logits_mismatch"]["value"] > 0


PROOF_CELLS = ["conv3.prove_add", "conv3.prove_mult"]


def _gadget(monkeypatch, cell, alter):
    """Replace the proof's gadget by one that builds from the arguments
    ``alter(args)`` gives: an add's (px, py, rx, ry, rz), a mult's
    (weights, px, py)."""
    from vpin_tpu_torch.runner import proof_runner
    name = ("point_addition_gadget" if cell == "conv3.prove_add"
            else "point_mult_gadget")
    gadget = getattr(proof_runner, name)

    def broken(*args, **kwargs):
        return gadget(*alter(args), **kwargs)

    monkeypatch.setattr(proof_runner, name, broken)


@pytest.mark.parametrize("cell", PROOF_CELLS)
def test_proof_answer_altered(bench, monkeypatch, cell):
    """A proof altered where it is produced: its claimed evaluations moved
    by one.  The verifier refuses it."""
    from vpin_tpu_torch.runner import proof_runner
    prove = proof_runner.cp_snark_prove
    calls = []

    def broken(*args, **kwargs):
        proof = prove(*args, **kwargs)
        calls.append(1)
        if len(calls) > 1:                  # the warm-up proof is sound
            a, b, c = proof.inst_evals
            proof.inst_evals = (a + 1, b, c)
        return proof

    monkeypatch.setattr(proof_runner, "cp_snark_prove", broken)
    line = run_small(bench, cell)
    assert line["correct"] is False
    assert line["checks"]["rejected"]["value"] > 0


@pytest.mark.parametrize("cell", PROOF_CELLS)
def test_proof_half_the_witness(bench, monkeypatch, cell):
    """A prover that proves only half of the adds or mults it is handed:
    the proof verifies, but its size is not the instance's."""
    _gadget(monkeypatch, cell,
            lambda args: [a[:max(1, len(a) // 2)] for a in args])
    line = run_small(bench, cell)
    assert line["correct"] is False
    assert line["checks"]["size_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", PROOF_CELLS)
def test_proof_of_another_witness(bench, monkeypatch, cell):
    """A prover that proves a witness other than the one it is handed (the
    first add's left x or the first mult's scalar moved by one): the proof
    verifies and is of the instance's size, and only the reference's
    commitments catch it."""
    _gadget(monkeypatch, cell,
            lambda args: [[args[0][0] + 1] + list(args[0][1:])]
            + list(args[1:]))
    line = run_small(bench, cell)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["commitment_mismatch"]["value"] > 0
    for k in ("witness_mismatch", "size_mismatch", "rejected", "failed"):
        assert checks[k]["value"] == 0, k


@pytest.mark.parametrize("cell", PROOF_CELLS)
def test_proof_of_a_weaker_circuit(bench, monkeypatch, cell):
    """A prover whose circuit has its last constraint replaced by a copy of
    the one before: the witness still satisfies it, the proof verifies and
    is of the instance's size, and only the reference's instance catches
    it."""
    from benchmark.tests.test_harness_spartan import weakened
    from vpin_tpu_torch.gadgets import point_addition, point_mult
    mod = point_addition if cell == "conv3.prove_add" else point_mult
    build = mod.build_matrices

    def broken(*args, **kwargs):
        A, B, C, nc, nv, ni = build(*args, **kwargs)
        return (*(weakened(m, nc) for m in (A, B, C)), nc, nv, ni)

    monkeypatch.setattr(mod, "build_matrices", broken)
    line = run_small(bench, cell)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["instance_mismatch"]["value"] > 0
    for k in ("commitment_mismatch", "witness_mismatch", "size_mismatch",
              "rejected"):
        assert checks[k]["value"] == 0, k


@pytest.mark.parametrize("cell,number", [
    ("conv3.serve_256", "output_mismatch"),
    ("cnn_a.serve_32", "logits_mismatch"),
    ("conv3.prove_add", "commitment_mismatch"),
    ("conv3.prove_add", "witness_mismatch"),
    ("conv3.prove_mult", "commitment_mismatch")])
def test_control(bench, cell, number):
    """Each cell's control (benchmark/control.py) is not correct."""
    line = run_small(bench, cell, control=True)
    assert line["correct"] is False
    assert line["checks"][number]["value"] > 0
