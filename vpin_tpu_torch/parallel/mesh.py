"""The device mesh of the sharded prover.

Port of vpin_tpu/parallel/mesh.py.  vpin_tpu's layer is single-controller:
one process sets a 1-D "dp" mesh and shard_map runs one body per device.
Here a mesh is a tuple of torch.devices on that axis, and parallel/ops.py
runs each shard's body on its device from the one process.  A device may
appear more than once (k shards on one card, the counterpart of XLA's
forced host device count); such shards run in turn.

A mesh is opt-in: set_mesh()/use_mesh() (dryrun_multichip does).  Without
one every entry of parallel/ops.py returns None and the caller runs its
single-device code; the proof bytes are the same either way.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

AXIS = "dp"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it names now (``cuda:0``), as tensors report
    their device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 1-D mesh: the devices of the shards along ``AXIS``, in order."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_indexed(torch.device(d)) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


_ACTIVE: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE
    _ACTIVE = mesh


def get_mesh() -> Optional[Mesh]:
    return _ACTIVE


def mesh_axis_size() -> int:
    return 1 if _ACTIVE is None else len(_ACTIVE.devices)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def default_mesh(n: Optional[int] = None, device_type: str = "cuda") -> Mesh:
    """A mesh of the first ``n`` distinct devices of ``device_type`` (all of
    them when None).  Raises when there are fewer: it never gives a smaller
    mesh than asked for."""
    if device_type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
    elif device_type == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    want = len(devs) if n is None else n
    if want < 1 or want > len(devs):
        raise RuntimeError(f"default_mesh: {want} {device_type} devices "
                           f"asked for, {len(devs)} present")
    return Mesh(devs[:want])
