"""Intra-proof checkpoints: a killed proof resumes where it stopped.

Port of vpin_tpu/utils/checkpoint.py.  The prover is deterministic given the
witness and ``tape_seed`` (challenges come from the merlin transcript, the
prover's randomness from the seeded RandomTape), so a checkpoint is small:
the sponge states and the protocol artifacts accumulated so far, all host
ints and bytes.  Bound sumcheck tables are never stored: they are a
function of the initial tables and the recorded challenges, so a resume
binds them again.

Snapshots are taken
  * every ROUNDS_PER_CHECKPOINT rounds inside each ZK sumcheck (keys ``sc1``
    and ``sc2``, sumcheck.py ``_prove_rounds``);
  * after the witness commitment (``witness_commit``,
    cp_snark.cp_commit_witness);
  * after the sat proof, before the SPARK eval proof (``post_sat``,
    cp_snark.cp_snark_prove).

The files are this package's own pickles: vpin_tpu's hold vpin_tpu objects,
so a directory written by one package does not resume in the other.  The
proof bytes are what both give alike.

    ckpt = CheckpointStore("ckpt_dir", meta)    # resumes if files exist
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

#: rounds between snapshots inside a sumcheck
ROUNDS_PER_CHECKPOINT = int(os.environ.get("VPIN_CKPT_ROUNDS", "4"))


class CheckpointStore:
    """Directory-backed key -> pickle store for prover checkpoints.  ``meta``
    names the proof run; a directory made for another run raises
    ValueError."""

    def __init__(self, dir_path: str, meta: Optional[dict] = None):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._meta_path = os.path.join(dir_path, "meta.pkl")
        if os.path.exists(self._meta_path):
            with open(self._meta_path, "rb") as fh:
                existing = pickle.load(fh)
            if meta is not None and existing != meta:
                raise ValueError(
                    f"checkpoint dir {dir_path} belongs to a different "
                    f"proof run: {existing} != {meta}")
        elif meta is not None:
            self._write(self._meta_path, meta)

    @staticmethod
    def _write(path: str, obj: Any) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)      # atomic: a kill never leaves a torn file

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key.replace("/", "__") + ".pkl")

    def save(self, key: str, obj: Any) -> None:
        self._write(self._path(key), obj)

    def load(self, key: str) -> Optional[Any]:
        p = self._path(key)
        if not os.path.exists(p):
            return None
        with open(p, "rb") as fh:
            return pickle.load(fh)

    def clear(self) -> None:
        for name in os.listdir(self.dir):
            if name.endswith(".pkl"):
                os.remove(os.path.join(self.dir, name))
