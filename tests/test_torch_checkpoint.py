"""The port's intra-proof checkpoints (vpin_tpu_torch/utils/checkpoint.py and
the ckpt plumbing of sumcheck, r1csproof, cp_snark and proof_runner) on the
CPU, against uninterrupted proofs of both packages.

Tolerance: exact.  A proof killed after a snapshot and resumed from its
directory must give the bytes of the uninterrupted proof of the same
witness and tape seed, which must equal vpin_tpu's.  The kill here is an
exception raised right after the snapshot lands on disk (chip_smoke.py
SIGKILLs a child process on the card).

Slow tier: the mult resume (2 mults, 128 bits: the witness scan's ~10^5
serial plain K1 calls, ~110 s on one CPU thread) and `cli mult-scale
--mults 2 --transparent --ckpt`.
"""

import contextlib
import io
import random

import pytest
import torch

from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER
from vpin_tpu_torch.gadgets.point_addition import point_addition_gadget
from vpin_tpu_torch.gadgets.point_mult import point_mult_gadget
from vpin_tpu_torch.runner import cli
from vpin_tpu_torch.runner import proof_runner as pr
from vpin_tpu_torch.utils.bincode import serialize_snark
from vpin_tpu_torch.utils.checkpoint import CheckpointStore

TAPE = 21


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _add_trace(n, seed=31):
    rng = random.Random(seed)
    px, py, rx, ry, rz = [], [], [], [], []
    for _ in range(n):
        P = rng.randrange(1, E2_ORDER) * E2_G_HOST
        R = rng.randrange(1, E2_ORDER) * E2_G_HOST
        px.append(P.x)
        py.append(P.y)
        rx.append(R.x)
        ry.append(R.y)
        rz.append(0)
    return px, py, rx, ry, rz


def _meta(kind, trace, tape=TAPE, n_bits=0):
    return {"kind": kind, "count": len(trace[0]), "tape_seed": tape,
            "n_bits": n_bits, "witness": pr._witness_digest(*trace)}


class Killed(Exception):
    pass


class _KillAt(CheckpointStore):
    """A store that dies right after the first snapshot ``key`` is on disk;
    with ``after="mid"`` only a snapshot taken inside its sumcheck (round
    j below the round count) counts."""

    def __init__(self, dir_path, meta, key, after=None):
        super().__init__(dir_path, meta)
        self.key, self.after = key, after

    def save(self, key, obj):
        super().save(key, obj)
        if key == self.key and (self.after is None
                                or obj["j"] < obj["num_rounds"]):
            raise Killed(key)


def _tensors_in(obj):
    if isinstance(obj, torch.Tensor):
        return 1
    if isinstance(obj, dict):
        return sum(_tensors_in(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensors_in(v) for v in obj)
    if hasattr(obj, "__dict__"):
        return _tensors_in(vars(obj))
    return 0


@pytest.fixture(scope="module")
def add16():
    """16 adds (160 constraints: 8 sc1 and 9 sc2 rounds), proven
    uninterrupted, transparent, by the port and by vpin_tpu."""
    from vpin_tpu.runner import proof_runner as jpr
    from vpin_tpu.utils.bincode import serialize_snark as jser
    trace = _add_trace(16)
    gadget = point_addition_gadget(*trace, device="cpu")
    proof, *_ = pr._prove_gadget(gadget, TAPE, "cpu", False)
    from vpin_tpu.gadgets.point_addition import point_addition_gadget as jpa
    jproof, *_ = jpr._prove_gadget(jpa(*trace), TAPE, True, full_snark=False)
    return trace, gadget, serialize_snark(proof), jser(jproof)


@pytest.mark.parametrize("key,after", [("sc1", "mid"), ("sc2", "mid"),
                                       ("witness_commit", None),
                                       ("post_sat", None)])
def test_kill_and_resume_byte_identical(tmp_path, add16, key, after):
    trace, gadget, want, jwant = add16
    assert want == jwant
    d = str(tmp_path / "ck")
    meta = _meta("point_add", trace)
    with pytest.raises(Killed):
        pr._prove_gadget(gadget, TAPE, "cpu", False,
                         ckpt=_KillAt(d, meta, key, after))
    store = CheckpointStore(d, meta)
    snap = store.load(key)
    assert snap is not None and _tensors_in(snap) == 0
    if after == "mid":
        assert 0 < snap["j"] < snap["num_rounds"]
    proof, *_ = pr._prove_gadget(gadget, TAPE, "cpu", False, ckpt=store)
    assert serialize_snark(proof) == want
    # the runner's own entry point resumes from the same directory and
    # verifies
    pr.RECORD = []
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            st = pr.prove_point_add(*trace, tape_seed=TAPE, device="cpu",
                                    full_snark=False, ckpt_dir=d)
        assert pr.RECORD == [("Point Addition", want)]
    finally:
        pr.RECORD = None
    assert st.size_bytes == len(want)


def test_meta_and_witness_mismatch_refused(tmp_path):
    d = str(tmp_path / "ck")
    CheckpointStore(d, meta={"kind": "point_add", "count": 4,
                             "tape_seed": 5, "n_bits": 0})
    with pytest.raises(ValueError):
        CheckpointStore(d, meta={"kind": "point_add", "count": 8,
                                 "tape_seed": 5, "n_bits": 0})
    t1, t2 = _add_trace(4, seed=1), _add_trace(4, seed=2)
    d2 = str(tmp_path / "ck2")
    pr._make_ckpt(d2, "point_add", 4, 5,
                  witness_digest=pr._witness_digest(*t1))
    with pytest.raises(ValueError):
        pr._make_ckpt(d2, "point_add", 4, 5,
                      witness_digest=pr._witness_digest(*t2))
    with pytest.raises(ValueError):
        pr.prove_point_add(*t1, tape_seed=None, device="cpu",
                           full_snark=False, ckpt_dir=str(tmp_path / "ck3"))
    store = CheckpointStore(d)
    store.save("x", {"a": 1})
    assert store.load("x") == {"a": 1} and store.load("y") is None
    store.clear()
    assert store.load("x") is None


def _mult_trace(n, seed=41):
    rng = random.Random(seed)
    ws, px, py = [], [], []
    for _ in range(n):
        ws.append(rng.randrange(1, 1 << 128))
        P = rng.randrange(1, E2_ORDER) * E2_G_HOST
        px.append(P.x)
        py.append(P.y)
    return ws, px, py


# the 128-step witness scan: about 10^5 serial plain K1 calls, ~110 s a proof
@pytest.mark.slow
def test_mult_kill_and_resume(tmp_path):
    trace = _mult_trace(2)
    gadget = point_mult_gadget(*trace, n=128, device="cpu")
    want = serialize_snark(pr._prove_gadget(gadget, 9, "cpu", False)[0])
    d = str(tmp_path / "ckm")
    meta = _meta("point_mult", trace, tape=9, n_bits=128)
    with pytest.raises(Killed):
        pr._prove_gadget(gadget, 9, "cpu", False,
                         ckpt=_KillAt(d, meta, "sc2", "mid"))
    proof, *_ = pr._prove_gadget(gadget, 9, "cpu", False,
                                 ckpt=CheckpointStore(d, meta))
    assert serialize_snark(proof) == want


@pytest.mark.slow
def test_cli_mult_scale_with_ckpt(tmp_path, capsys):
    d = str(tmp_path / "ck")
    assert cli.main(["mult-scale", "--mults", "2", "--transparent", "--ckpt",
                     d, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Number of Point Multiplications: 2" in out
    assert "Proof verification successful!" in out
    # a second run resumes past the sat proof and gives the same size
    assert cli.main(["mult-scale", "--mults", "2", "--transparent", "--ckpt",
                     d, "--device", "cpu"]) == 0
    again = capsys.readouterr().out
    size = [ln for ln in out.splitlines() if ln.startswith("Proof size")]
    assert size and size == [ln for ln in again.splitlines()
                             if ln.startswith("Proof size")]
