from .cp_snark import (
    CPSnarkProof, SNARKGens, cp_commit_witness, cp_snark_prove,
    cp_snark_verify, pad_assignment, snark_encode,
)
from .r1cs import R1CSInstance, SparseMat
from .r1csproof import (
    PolyCommitment, PolyEvalProof, R1CSGens, R1CSProof, poly_commit,
    r1cs_prove_cp, r1cs_verify_cp,
)

__all__ = [
    "R1CSInstance", "SparseMat", "R1CSGens", "R1CSProof", "PolyCommitment",
    "PolyEvalProof", "poly_commit", "r1cs_prove_cp",
    "r1cs_verify_cp", "SNARKGens", "CPSnarkProof", "cp_commit_witness",
    "cp_snark_prove", "cp_snark_verify", "pad_assignment", "snark_encode",
]
