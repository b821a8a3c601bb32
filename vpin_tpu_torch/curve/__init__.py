from .host_ec import (
    E2_A, E2_B, E2_G_HOST, E2_HOST, E2_ORDER, E2_P, HostCurve, HostPoint,
    host_infinity,
)
from .weierstrass import E2, PointW, WeierstrassCurve, scalars_to_bits

__all__ = [
    "E2", "PointW", "WeierstrassCurve", "scalars_to_bits",
    "E2_HOST", "E2_G_HOST", "E2_ORDER", "E2_P", "E2_A", "E2_B",
    "HostCurve", "HostPoint", "host_infinity",
]
