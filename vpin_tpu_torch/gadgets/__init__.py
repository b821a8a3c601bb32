from .point_addition import point_addition_gadget
from .point_mult import point_mult_gadget

__all__ = ["point_addition_gadget", "point_mult_gadget"]
