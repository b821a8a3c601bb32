"""The stock (non-commit-and-prove) Spartan SNARK and the synthetic R1CS.

Port of vpin_tpu/snark/stock.py (reference Spartan/src/lib.rs:360-487,
SNARK::prove / verify: the R1CS matrices' commitment enters the transcript
under "comm" and the stock R1CSProof appends `input` and commits the
witness itself; r1csinstance.rs:160-238, produce_synthetic_r1cs, which the
reference's tests, benches and 2^10..2^20 profiler sweep use).  The prover
runs on the instance's device; the verifier runs on the host.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..batch_verify import VerifyAccumulator
from ..field.prime_field import L_MODULUS as L
# a module reference: spark/sparse_mlpoly.py imports snark/r1csproof.py
from ..spark import sparse_mlpoly as spark
from ..transcript.merlin import RandomTape, Transcript
from ..utils.errors import InternalError, verify_guard
from ..utils.timer import span
from .cp_snark import SNARK_PROTOCOL, SNARKGens, snark_encode
from .r1cs import R1CSInstance
from .r1csproof import R1CSProof, r1cs_prove_stock, r1cs_verify_stock


def produce_synthetic_r1cs(num_cons: int, num_vars: int, num_inputs: int,
                           seed: Optional[int] = None, device=None
                           ) -> Tuple[R1CSInstance, List[int], List[int]]:
    """A random satisfiable R1CS (reference r1csinstance.rs:160-238), drawn
    from random.Random(seed) in vpin_tpu's order, so both packages give the
    same instance.  -> (instance on ``device``, vars, inputs)."""
    if num_cons & (num_cons - 1) or num_vars & (num_vars - 1):
        raise ValueError("num_cons and num_vars must be powers of two")
    if num_inputs >= num_vars:
        raise ValueError("num_inputs must be below num_vars")
    rng = random.Random(seed)

    size_z = num_vars + num_inputs + 1
    Z = [rng.randrange(L) for _ in range(size_z)]
    Z[num_vars] = 1

    A, B, C = [], [], []
    for i in range(num_cons):
        a_idx = i % size_z
        b_idx = (i + 2) % size_z
        A.append((i, a_idx, 1))
        B.append((i, b_idx, 1))
        ab = Z[a_idx] * Z[b_idx] % L
        c_idx = (i + 3) % size_z
        c_val = Z[c_idx]
        if c_val == 0:
            C.append((i, num_vars, ab))
        else:
            C.append((i, c_idx, ab * pow(c_val, -1, L) % L))

    inst = R1CSInstance(num_cons, num_vars, num_inputs, A, B, C, device=device)
    vars_ints = Z[:num_vars]
    inputs = Z[num_vars + 1:]
    if not inst.is_sat(vars_ints, inputs):
        raise InternalError("the synthetic R1CS is not satisfied")
    return inst, vars_ints, inputs


@dataclass
class SNARK:
    """The stock SNARK (lib.rs SNARK struct)."""
    r1cs_sat_proof: R1CSProof
    inst_evals: Tuple[int, int, int]
    r1cs_eval_proof: "spark.R1CSEvalProof"

    def size(self) -> int:
        """Its bincode length (the SNARK struct's fields in order)."""
        from ..utils.bincode import serialize_snark
        return len(serialize_snark(self))

    @staticmethod
    def prove(inst: R1CSInstance, comm, decomm, vars_ints: List[int],
              inputs: List[int], gens: SNARKGens, transcript: Transcript,
              tape_seed: Optional[int] = None) -> "SNARK":
        tape = RandomTape(b"proof", seed=tape_seed)
        transcript.append_protocol_name(SNARK_PROTOCOL)
        comm.append_to_transcript(b"comm", transcript)

        padded = list(vars_ints) + [0] * (inst.num_vars - len(vars_ints))
        with span("R1CSProof::prove"):
            sat_proof, rx, ry = r1cs_prove_stock(
                inst, padded, inputs, gens.gens_r1cs_sat, transcript, tape)

        with span("eval_sparse_polys"):
            Ar, Br, Cr = inst.evaluate(rx, ry)
        transcript.append_scalar(b"Ar_claim", Ar)
        transcript.append_scalar(b"Br_claim", Br)
        transcript.append_scalar(b"Cr_claim", Cr)

        with span("R1CSEvalProof::prove"):
            eval_proof = spark.R1CSEvalProof.prove(
                decomm, rx, ry, (Ar, Br, Cr), gens.gens_r1cs_eval,
                transcript, tape)
        return SNARK(sat_proof, (Ar, Br, Cr), eval_proof)

    @verify_guard(failure=False)
    def verify(self, comm, inst: R1CSInstance, inputs: List[int],
               transcript: Transcript, gens: SNARKGens) -> bool:
        """Host-only; every group equation deferred into one batched
        check."""
        acc = VerifyAccumulator()
        transcript.append_protocol_name(SNARK_PROTOCOL)
        comm.append_to_transcript(b"comm", transcript)

        res = r1cs_verify_stock(
            self.r1cs_sat_proof, gens.num_vars_padded, inst.num_cons,
            inputs, self.inst_evals, transcript, gens.gens_r1cs_sat, acc=acc)
        if res is None:
            return False
        rx, ry = res

        Ar, Br, Cr = self.inst_evals
        transcript.append_scalar(b"Ar_claim", Ar)
        transcript.append_scalar(b"Br_claim", Br)
        transcript.append_scalar(b"Cr_claim", Cr)
        if not self.r1cs_eval_proof.verify(
                comm, rx, ry, self.inst_evals, gens.gens_r1cs_eval,
                transcript, acc=acc):
            return False
        return acc.check()


def snark_prove_synthetic(num_cons: int, num_vars: int, num_inputs: int,
                          seed: int = 0, tape_seed: Optional[int] = None,
                          device=None):
    """The stock SNARK end to end on a synthetic instance, the reference
    profiler's flow (Spartan/profiler/snark.rs): -> (proof, verified,
    size in bytes)."""
    inst, vars_ints, inputs = produce_synthetic_r1cs(
        num_cons, num_vars, num_inputs, seed, device=device)
    gens = SNARKGens(inst.num_cons, inst.num_vars, inst.num_inputs,
                     max(m.nnz for m in (inst.A, inst.B, inst.C)))
    comm, decomm = snark_encode(inst, gens)
    pt = Transcript(b"snark_example")
    proof = SNARK.prove(inst, comm, decomm, vars_ints, inputs, gens, pt,
                        tape_seed=tape_seed)
    vt = Transcript(b"snark_example")
    ok = proof.verify(comm, inst, inputs, vt, gens)
    return proof, ok, proof.size()
