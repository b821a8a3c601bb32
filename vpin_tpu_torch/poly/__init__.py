from .dense import DensePoly, eq_evals, eq_evals_host, factored_lens

__all__ = ["DensePoly", "eq_evals", "eq_evals_host", "factored_lens"]
