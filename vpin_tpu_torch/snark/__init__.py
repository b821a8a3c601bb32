from .cp_snark import (
    CPSnarkProof, SNARKGens, cp_commit_witness, cp_snark_prove,
    cp_snark_verify, pad_assignment, snark_encode,
)
from .nizk_api import NIZK, NIZKGens, instance_digest
from .r1cs import R1CSInstance, SparseMat
from .r1csproof import (
    PolyCommitment, PolyEvalProof, R1CSGens, R1CSProof, combined_commit,
    poly_commit, r1cs_prove_cp, r1cs_prove_stock, r1cs_verify_cp,
    r1cs_verify_stock,
)
from .stock import SNARK, produce_synthetic_r1cs, snark_prove_synthetic

__all__ = [
    "R1CSInstance", "SparseMat", "R1CSGens", "R1CSProof", "PolyCommitment",
    "PolyEvalProof", "poly_commit", "combined_commit", "r1cs_prove_cp",
    "r1cs_verify_cp", "r1cs_prove_stock", "r1cs_verify_stock", "SNARKGens",
    "CPSnarkProof", "cp_commit_witness", "cp_snark_prove", "cp_snark_verify",
    "pad_assignment", "snark_encode", "NIZK", "NIZKGens", "instance_digest",
    "SNARK", "produce_synthetic_r1cs", "snark_prove_synthetic",
]
