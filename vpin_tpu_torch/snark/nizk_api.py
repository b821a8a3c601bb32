"""Spartan NIZK (the non-preprocessing variant) and the R1CS instance digest.

Port of vpin_tpu/snark/nizk_api.py (reference Spartan/src/lib.rs:489-609 and
r1csinstance.rs get_digest, :154-158).  The verifier evaluates the public
R1CS matrices itself, so there is no SPARK eval proof; it runs on the host
(``R1CSInstance.evaluate_host``) whatever the instance's size.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List, Tuple

from ..batch_verify import VerifyAccumulator
from ..transcript.merlin import RandomTape, Transcript
from ..utils.bincode import Writer
from ..utils.errors import verify_guard
from .r1cs import R1CSInstance
from .r1csproof import R1CSGens, R1CSProof, r1cs_prove_stock, r1cs_verify_stock

NIZK_PROTOCOL = b"Spartan NIZK proof"


def instance_digest(inst: R1CSInstance) -> bytes:
    """zlib(bincode(R1CSInstance)), the byte layout of the reference's serde
    derive: the u64 dimensions, then each SparseMatPolynomial as
    (num_vars_x u64, num_vars_y u64, Vec<(row u64, col u64, Scalar)>)."""
    w = Writer()
    w.u64(inst.num_cons).u64(inst.num_vars).u64(inst.num_inputs)
    nvx = inst.num_cons.bit_length() - 1
    nvy = (2 * inst.num_vars).bit_length() - 1
    for mat in (inst.A, inst.B, inst.C):
        w.u64(nvx).u64(nvy)
        entries = mat.entries
        w.u64(len(entries))
        for r, c, v in entries:
            w.u64(r).u64(c).scalar(v)
    return zlib.compress(w.bytes())


class NIZKGens:
    def __init__(self, num_cons: int, num_vars: int, num_inputs: int):
        num_vars_padded = max(num_vars, num_inputs + 1)
        if num_vars_padded & (num_vars_padded - 1):
            num_vars_padded = 1 << num_vars_padded.bit_length()
        self.num_vars_padded = num_vars_padded
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons,
                                      num_vars_padded)


@dataclass
class NIZK:
    r1cs_sat_proof: R1CSProof
    r: Tuple[List[int], List[int]]

    @staticmethod
    def prove(inst: R1CSInstance, vars_ints: List[int], inputs: List[int],
              gens: NIZKGens, transcript: Transcript,
              tape_seed=None) -> "NIZK":
        """The sat proof on the instance's device."""
        tape = RandomTape(b"proof", seed=tape_seed)
        transcript.append_protocol_name(NIZK_PROTOCOL)
        transcript.append_message(b"R1CSInstanceDigest", instance_digest(inst))
        padded = list(vars_ints) + [0] * (inst.num_vars - len(vars_ints))
        proof, rx, ry = r1cs_prove_stock(inst, padded, inputs,
                                         gens.gens_r1cs_sat, transcript, tape)
        return NIZK(proof, (rx, ry))

    @verify_guard(failure=False)
    def verify(self, inst: R1CSInstance, inputs: List[int],
               transcript: Transcript, gens: NIZKGens) -> bool:
        """Host-only: the matrices' evaluations by
        ``R1CSInstance.evaluate_host``, every group equation deferred into
        one batched check."""
        transcript.append_protocol_name(NIZK_PROTOCOL)
        transcript.append_message(b"R1CSInstanceDigest", instance_digest(inst))
        claimed_rx, claimed_ry = self.r
        acc = VerifyAccumulator()
        inst_evals = inst.evaluate_host(claimed_rx, claimed_ry)
        res = r1cs_verify_stock(self.r1cs_sat_proof, inst.num_vars,
                                inst.num_cons, inputs, inst_evals,
                                transcript, gens.gens_r1cs_sat, acc=acc)
        if res is None:
            return False
        rx, ry = res
        if list(rx) != list(claimed_rx) or list(ry) != list(claimed_ry):
            return False
        return acc.check()
