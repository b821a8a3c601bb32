from .product_tree import (
    BatchedDotProducts, BatchedProductCircuits, LayerProofBatched,
    ProductCircuitEvalProofBatched,
)
from .sparse_mlpoly import (
    AddrTimestamps, MultiSparseMatPolynomialAsDense, R1CSEvalProof,
    SparseMatPolyCommitment, SparseMatPolyCommitmentGens,
    SparseMatPolyEvalProof, multi_commit,
)

__all__ = [
    "AddrTimestamps", "SparseMatPolyCommitmentGens", "SparseMatPolyCommitment",
    "MultiSparseMatPolynomialAsDense", "SparseMatPolyEvalProof",
    "R1CSEvalProof", "multi_commit", "BatchedProductCircuits",
    "BatchedDotProducts", "LayerProofBatched", "ProductCircuitEvalProofBatched",
]
