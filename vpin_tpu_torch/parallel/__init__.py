"""The sharded prover: a 1-D device mesh and the entries that split the
prover's table work over it (port of vpin_tpu/parallel/)."""

from .mesh import (
    Mesh, default_mesh, get_mesh, mesh_axis_size, set_mesh, use_mesh,
)
from .ops import (
    ENGAGED, sharded_bound_top, sharded_msm_digits, sharded_regular_reduce,
    sharded_round_evals,
)

__all__ = [
    "Mesh", "default_mesh", "get_mesh", "mesh_axis_size", "set_mesh",
    "use_mesh", "ENGAGED", "sharded_bound_top", "sharded_msm_digits",
    "sharded_regular_reduce", "sharded_round_evals",
]
