"""The sharded prover's entries over the active mesh (parallel/mesh.py).

Port of vpin_tpu/parallel/ops.py, whose shard_map bodies become a loop over
the mesh's devices in one process:

  * Hyrax row commits (rayon par_iter, Spartan/src/dense_mlpoly.rs:160-175)
    -> MSM digit rows split over the mesh, each shard one K4 ``ed_msm`` on
    its device, the digit table copied once per distinct device;
  * sumcheck round partial sums -> the eval tables' half axis split, each
    shard's partials from the K1 round sums of its lo/hi slices, combined
    by an exact modular sum;
  * R1CS multiply_vec (r1csinstance.rs:272-286) -> segment rows split, z
    replicated;
  * bound_poly_var_top (dense_mlpoly.rs:229-238) -> the half axis split.

Results land on the mesh's first device.  Shards on one card run in turn.
Every entry returns None without a mesh or when the shape does not divide,
and the caller runs its single-device code; the results are the same
either way (field sums are associative mod l; every point is encoded
before it leaves the prover).  ``ENGAGED`` counts the calls each entry took.
"""

from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..field import FQ
from .mesh import get_mesh, mesh_axis_size

#: entry -> calls that ran sharded
ENGAGED = {"msm_digits": 0, "round_evals": 0, "bound_top": 0,
           "regular_reduce": 0}

#: a digit table's x limbs -> {device: the table on that device}
_TABLES = WeakIdKeyDictionary()


def _shardable(n: int) -> bool:
    nd = mesh_axis_size()
    return nd > 1 and n % nd == 0 and n // nd >= 1


def _shards(mesh, n: int):
    """(device, slice) of each shard of a leading axis of length n."""
    m = n // len(mesh.devices)
    return [(d, slice(s * m, (s + 1) * m)) for s, d in enumerate(mesh.devices)]


def _replicate(t: torch.Tensor, mesh) -> dict:
    """``t`` on each distinct device of the mesh (itself where it lies)."""
    return {d: t.to(d) for d in mesh.distinct}


def _table_on(table, dev):
    from ..curve.ristretto import PointE
    if table.x.device == dev:
        return table
    copies = _TABLES.setdefault(table.x, {})
    if dev not in copies:
        copies[dev] = PointE(*(c.to(dev) for c in table))
    return copies[dev]


# ----------------------------------------------------------------------
# Hyrax / Pedersen MSM rows
# ----------------------------------------------------------------------

def sharded_msm_digits(group, table, digits: torch.Tensor):
    """digits (rows, n, 32) uint8 -> PointE (rows,), rows split over the
    mesh; or None."""
    from ..curve import cuda_edwards
    from ..curve.ristretto import PointE
    mesh = get_mesh()
    rows = digits.shape[0]
    if mesh is None or not _shardable(rows):
        return None
    home = mesh.devices[0]
    outs = [cuda_edwards.ed_msm(group, tuple(_table_on(table, dev)),
                                digits[rs].to(dev))
            for dev, rs in _shards(mesh, rows)]
    ENGAGED["msm_digits"] += 1
    return PointE(*(torch.cat([o[c].to(home) for o in outs])
                    for c in range(4)))


# ----------------------------------------------------------------------
# sumcheck round partial sums
# ----------------------------------------------------------------------

def sharded_round_evals(kind: str, tables):
    """tables: (2n, 8) eval tables of one length -> (points, 8) Montgomery
    round sums (sumcheck.round_sums's), the half axis split over the mesh
    and the shards' partials summed exactly; or None."""
    from ..sumcheck.sumcheck import round_sums_split
    mesh = get_mesh()
    n2 = tables[0].shape[0] // 2
    if mesh is None or not _shardable(n2):
        return None
    home = mesh.devices[0]
    parts = [round_sums_split(kind, [t[:n2][rs].to(dev) for t in tables],
                              [t[n2:][rs].to(dev) for t in tables]).to(home)
             for dev, rs in _shards(mesh, n2)]
    ENGAGED["round_evals"] += 1
    return FQ.sum_reduce(torch.stack(parts), axis=0)


# ----------------------------------------------------------------------
# bound_poly_var_top
# ----------------------------------------------------------------------

def sharded_bound_top(Z: torch.Tensor, r: int):
    """Z (n, 8) -> (n/2, 8) bound at r, the half axis split; or None."""
    from ..poly.dense import bind_halves
    mesh = get_mesh()
    n2 = Z.shape[0] // 2
    if mesh is None or not _shardable(n2):
        return None
    home = mesh.devices[0]
    r_dev = _replicate(FQ.to_mont([r], home)[0], mesh)
    outs = [bind_halves(Z[:n2][rs].to(dev), Z[n2:][rs].to(dev),
                        r_dev[dev]).to(home)
            for dev, rs in _shards(mesh, n2)]
    ENGAGED["bound_top"] += 1
    return torch.cat(outs)


# ----------------------------------------------------------------------
# R1CS multiply_vec rows
# ----------------------------------------------------------------------

def sharded_regular_reduce(vals: torch.Tensor, idx: torch.Tensor,
                           z: torch.Tensor, nseg: int):
    """out[s] = sum_k vals[s, k] * z[idx[s, k]] over nseg segment rows,
    the rows split and z replicated; or None."""
    from ..snark.r1cs import regular_reduce
    mesh = get_mesh()
    if mesh is None or not _shardable(nseg):
        return None
    home = mesh.devices[0]
    zs = _replicate(z, mesh)
    outs = [regular_reduce(vals[rs].to(dev), idx[rs].to(dev), zs[dev]).to(home)
            for dev, rs in _shards(mesh, nseg)]
    ENGAGED["regular_reduce"] += 1
    return torch.cat(outs)
