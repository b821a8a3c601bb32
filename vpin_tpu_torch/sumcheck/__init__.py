from .sumcheck import UniPoly, ZKSumcheckInstanceProof

__all__ = ["UniPoly", "ZKSumcheckInstanceProof"]
