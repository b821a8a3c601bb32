from .limbs import N_LIMBS, int_to_limbs, limbs_to_int
from .prime_field import FP, FQ, L_MODULUS, P_MODULUS, PrimeField

__all__ = ["FP", "FQ", "L_MODULUS", "P_MODULUS", "N_LIMBS", "PrimeField",
           "int_to_limbs", "limbs_to_int"]
