"""The port's stock Spartan SNARK, NIZK and synthetic R1CS (vpin_tpu_torch/
snark/stock.py, snark/nizk_api.py, utils/bincode.py's NIZK) on the CPU, where
K1 and K4 run their plain PyTorch versions, against vpin_tpu.

Tolerance: exact.  The synthetic instance (entries, variables, inputs), the
instance digest and the proof bytes must equal vpin_tpu's for the same
seeds and tape seed, and each package's verifier must accept the other's
deserialized proof.
"""

import pytest
import torch

from vpin_tpu.snark import NIZK as JNIZK
from vpin_tpu.snark import NIZKGens as JNIZKGens
from vpin_tpu.snark import instance_digest as jdigest
from vpin_tpu.snark import produce_synthetic_r1cs as jproduce
from vpin_tpu.transcript.merlin import Transcript as JTranscript
from vpin_tpu.utils.bincode import deserialize_nizk as jdes_nizk
from vpin_tpu.utils.bincode import serialize_nizk as jser_nizk
from vpin_tpu_torch.field.prime_field import L_MODULUS as L
from vpin_tpu_torch.snark import (
    NIZK, SNARK, NIZKGens, R1CSInstance, SNARKGens, instance_digest,
    produce_synthetic_r1cs, snark_encode,
)
from vpin_tpu_torch.transcript import Transcript
from vpin_tpu_torch.utils.bincode import (
    deserialize_nizk, deserialize_snark, serialize_nizk, serialize_snark,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(64, 64, 10), (1 << 10, 1 << 10, 10)])
def test_synthetic_r1cs_equals_vpin_tpu(shape):
    inst, vars_ints, inputs = produce_synthetic_r1cs(*shape, seed=3,
                                                     device="cpu")
    jinst, jvars, jinputs = jproduce(*shape, seed=3)
    assert vars_ints == jvars and inputs == jinputs
    for M, J in ((inst.A, jinst.A), (inst.B, jinst.B), (inst.C, jinst.C)):
        assert M.entries == J.entries
    assert (inst.num_cons, inst.num_vars, inst.num_inputs) == \
        (jinst.num_cons, jinst.num_vars, jinst.num_inputs)
    assert instance_digest(inst) == jdigest(jinst)
    assert inst.is_sat(vars_ints, inputs)
    bad = list(vars_ints)
    bad[0] = (bad[0] + 1) % L
    assert not inst.is_sat(bad, inputs)


def test_instance_rejects_invalid_index():
    # A deliberate difference: the reference's Instance::new returns
    # InvalidIndexError (lib.rs:619-668) and vpin_tpu asserts
    # (vpin_tpu/snark/r1cs.py:231); the port raises ValueError.
    with pytest.raises(ValueError):
        R1CSInstance(4, 4, 0, [(99, 0, 1)], [(0, 0, 1)], [(0, 0, 1)],
                     device="cpu")
    with pytest.raises(ValueError):
        R1CSInstance(4, 4, 0, [(0, 99, 1)], [(0, 0, 1)], [(0, 0, 1)],
                     device="cpu")


def test_nizk_bytes_equal_vpin_tpu_and_cross_verify():
    inst, vars_ints, inputs = produce_synthetic_r1cs(32, 32, 5, seed=4,
                                                     device="cpu")
    jinst, jvars, jinputs = jproduce(32, 32, 5, seed=4)
    gens, jgens = NIZKGens(32, 32, 5), JNIZKGens(32, 32, 5)
    plog, jlog = [], []
    proof = NIZK.prove(inst, vars_ints, inputs, gens,
                       Transcript(b"nizk_example", log=plog), tape_seed=9)
    jproof = JNIZK.prove(jinst, jvars, jinputs, jgens,
                         JTranscript(b"nizk_example", log=jlog), tape_seed=9)
    assert plog == jlog
    blob, jblob = serialize_nizk(proof), jser_nizk(jproof)
    assert blob == jblob
    assert serialize_nizk(deserialize_nizk(blob)) == blob
    with pytest.raises(ValueError):
        deserialize_nizk(blob + b"\x00")
    assert deserialize_nizk(jblob).verify(inst, inputs,
                                          Transcript(b"nizk_example"), gens)
    assert jdes_nizk(blob).verify(jinst, jinputs,
                                  JTranscript(b"nizk_example"), jgens)
    bad = deserialize_nizk(blob)
    bad.r[1][0] = (bad.r[1][0] + 1) % L
    assert not bad.verify(inst, inputs, Transcript(b"nizk_example"), gens)


def test_stock_snark_bytes_equal_vpin_tpu():
    """64 x 64 (the port's plain SPARK: ~20 s on one CPU thread)."""
    from vpin_tpu.snark import snark_prove_synthetic as jprove
    from vpin_tpu.utils.bincode import serialize_snark as jser
    inst, vars_ints, inputs = produce_synthetic_r1cs(64, 64, 10, seed=1,
                                                     device="cpu")
    gens = SNARKGens(inst.num_cons, inst.num_vars, inst.num_inputs,
                     max(m.nnz for m in (inst.A, inst.B, inst.C)))
    comm, decomm = snark_encode(inst, gens)
    proof = SNARK.prove(inst, comm, decomm, vars_ints, inputs, gens,
                        Transcript(b"snark_example"), tape_seed=2)
    jproof, jok, jsize = jprove(64, 64, 10, seed=1, tape_seed=2)
    blob = serialize_snark(proof)
    assert jok and blob == jser(jproof) and proof.size() == jsize == len(blob)
    assert proof.verify(comm, inst, inputs, Transcript(b"snark_example"),
                        gens)
    # the tampered claim is refused
    proof.inst_evals = ((proof.inst_evals[0] + 1) % L,) + \
        tuple(proof.inst_evals[1:])
    assert proof.verify(comm, inst, inputs, Transcript(b"snark_example"),
                        gens) is False
    assert deserialize_snark(blob).r1cs_eval_proof is not None

