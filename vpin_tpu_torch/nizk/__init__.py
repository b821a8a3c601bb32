from .sigma import (
    BulletReductionProof, DotProductProof, DotProductProofGens,
    DotProductProofLog, EqualityProof, KnowledgeProof, ProductProof,
    append_scalars_vector, commit1, commitN, dot_ints,
)

__all__ = [
    "KnowledgeProof", "EqualityProof", "ProductProof",
    "DotProductProof", "DotProductProofLog", "DotProductProofGens",
    "BulletReductionProof", "append_scalars_vector", "dot_ints",
    "commit1", "commitN",
]
