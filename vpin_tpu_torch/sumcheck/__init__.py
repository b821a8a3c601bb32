from .sumcheck import SumcheckInstanceProof, UniPoly, ZKSumcheckInstanceProof

__all__ = ["UniPoly", "SumcheckInstanceProof", "ZKSumcheckInstanceProof"]
