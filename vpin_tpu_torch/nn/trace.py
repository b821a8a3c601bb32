"""EC witness trace: device-resident recording + Rust-compatible JSON export.

Port of vpin_tpu/nn/trace.py, with the same finalize() keys and the same
JSON files byte for byte.  Recording appends whole device batches; the
conversion to affine integers happens once, in finalize(), with one batched
inversion.

  pointMult/weight.json                  : list of decimal strings
  pointMult/point_mult_p{x,y}_byte.json  : N x 32 little-endian byte ints
  pointAdd/point_add_{px,py,rx,ry}_byte.json, point_add_rz_byte.json
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..curve.weierstrass import E2, PointW, cat_points
from ..field.limbs import N_LIMBS


def _concat_points(chunks: List[PointW], device) -> PointW:
    if not chunks:
        return E2.infinity((0,), device)
    return cat_points([PointW(*(c.reshape(-1, N_LIMBS) for c in p))
                       for p in chunks])


def int_to_byte_list(v: int) -> list:
    """32-byte little-endian list (reference intToByte, Server.py:601-612)."""
    return list(int(v).to_bytes(32, "little"))


@dataclass
class WitnessTrace:
    """Accumulates recorded point-mults (base, scalar) and point-adds (P, R)."""

    mult_bases: List[PointW] = field(default_factory=list)
    mult_scalars: List[int] = field(default_factory=list)
    add_left: List[PointW] = field(default_factory=list)
    add_right: List[PointW] = field(default_factory=list)

    def record_mults(self, bases: PointW, scalars) -> None:
        """bases: PointW batch (n, ...); scalars: n host ints, in order."""
        flat = [int(s) for s in np.asarray(scalars, dtype=object).reshape(-1)]
        n = int(np.prod(bases.batch_shape, dtype=np.int64))
        if n != len(flat):
            raise ValueError(f"{n} bases for {len(flat)} scalars")
        self.mult_bases.append(bases)
        self.mult_scalars.extend(flat)

    def record_adds(self, left: PointW, right: PointW) -> None:
        """left[i] + right[i] was performed; both flattened in order."""
        self.add_left.append(left)
        self.add_right.append(right)

    @property
    def num_mults(self) -> int:
        return len(self.mult_scalars)

    @property
    def num_adds(self) -> int:
        return sum(int(np.prod(c.batch_shape, dtype=np.int64))
                   for c in self.add_left)

    def finalize(self):
        """-> dict of numpy arrays of affine integer coordinates."""
        recorded = self.mult_bases + self.add_left + self.add_right
        dev = recorded[0].device if recorded else torch.device("cpu")
        mb = _concat_points(self.mult_bases, dev)
        al = _concat_points(self.add_left, dev)
        ar = _concat_points(self.add_right, dev)
        n_m = mb.batch_shape[0]
        n_a = al.batch_shape[0]
        x, y, inf = E2.to_affine(cat_points([mb, al, ar]))
        xs = E2.F.from_mont(x)
        ys = E2.F.from_mont(y)
        infs = inf.cpu().numpy()
        return {
            "mult_px": xs[:n_m], "mult_py": ys[:n_m],
            "mult_inf": infs[:n_m],
            "mult_scalars": list(self.mult_scalars),
            "add_px": xs[n_m:n_m + n_a], "add_py": ys[n_m:n_m + n_a],
            "add_p_inf": infs[n_m:n_m + n_a],
            "add_rx": xs[n_m + n_a:], "add_ry": ys[n_m + n_a:],
            "add_r_inf": infs[n_m + n_a:],
        }

    def export_json(self, out_dir: str, mult_slice=None, add_slice=None,
                    _finalized=None) -> None:
        """Write the Rust-loader-compatible JSON files under out_dir."""
        fin = _finalized if _finalized is not None else self.finalize()
        ms = mult_slice or (0, len(fin["mult_scalars"]))
        as_ = add_slice or (0, len(fin["add_px"]))

        mdir = os.path.join(out_dir, "pointMult")
        adir = os.path.join(out_dir, "pointAdd")
        os.makedirs(mdir, exist_ok=True)
        os.makedirs(adir, exist_ok=True)

        sl = slice(*ms)
        _dump(os.path.join(mdir, "weight.json"),
              [str(int(w)) for w in fin["mult_scalars"][sl]])
        _dump(os.path.join(mdir, "point_mult_px_byte.json"),
              [int_to_byte_list(v) for v in fin["mult_px"][sl]])
        _dump(os.path.join(mdir, "point_mult_py_byte.json"),
              [int_to_byte_list(v) for v in fin["mult_py"][sl]])

        sl = slice(*as_)
        _dump(os.path.join(adir, "point_add_px_byte.json"),
              [int_to_byte_list(v) for v in fin["add_px"][sl]])
        _dump(os.path.join(adir, "point_add_py_byte.json"),
              [int_to_byte_list(v) for v in fin["add_py"][sl]])
        # R at infinity encodes as rz=1 with zero coordinates
        # (reference: Server.py:661-676)
        rxs, rys, rzs = [], [], []
        for x, y, inf in zip(fin["add_rx"][sl], fin["add_ry"][sl],
                             fin["add_r_inf"][sl]):
            if inf:
                rzs.append(1)
                rxs.append(int_to_byte_list(0))
                rys.append(int_to_byte_list(0))
            else:
                rzs.append(0)
                rxs.append(int_to_byte_list(x))
                rys.append(int_to_byte_list(y))
        _dump(os.path.join(adir, "point_add_rx_byte.json"), rxs)
        _dump(os.path.join(adir, "point_add_ry_byte.json"), rys)
        _dump(os.path.join(adir, "point_add_rz_byte.json"), rzs)


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
