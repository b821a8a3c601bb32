"""Proof generation: witness JSON or trace -> CP-SNARK prove + verify.

Port of vpin_tpu/runner/proof_runner.py.  By default (``full_snark=True``)
it proves the full SNARK, with the SPARK eval proof over the committed R1CS
matrices; ``full_snark=False`` proves in transparent mode, where the verifier
evaluates the public matrices itself.  It prints the reference CLI's metric
lines (vPIN_proof_generation/src/main.rs:14-46, proof_point_add.rs:23-113):

    Point Addition Gadget...
    Number of Point Additions: N
    Proof size: N bytes
    Proof generation time: N ms
    Proof verification time: N ms
    ...
    Total proof size / generation time / verification time

Witnesses load from a WitnessTrace (in-process) or from the
`rust_files/<tag>` JSON layout.  The prover runs on ``device`` (the GPU
unless the caller passes "cpu"); the verifier runs on the host.

``ckpt_dir`` makes a proof resumable (utils/checkpoint.py): a proof killed
mid-way and started again over the same directory, witness and
``tape_seed`` goes on where it stopped and gives the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..device import resolve_device, synchronize
from ..gadgets.point_addition import point_addition_gadget
from ..gadgets.point_mult import point_mult_gadget
from ..snark.cp_snark import (
    SNARKGens, cp_commit_witness, cp_snark_prove, cp_snark_verify,
    snark_encode,
)
from ..transcript.merlin import Transcript
from ..utils.bincode import serialize_snark
from ..utils.checkpoint import CheckpointStore
from ..utils.timer import span

#: set to a list to collect (gadget label, proof bytes) of every proof made
RECORD: Optional[List[Tuple[str, bytes]]] = None


def _bytes_to_int(row) -> int:
    return int.from_bytes(bytes(int(b) & 0xFF for b in row), "little")


def _load(d: str, name: str):
    with open(os.path.join(d, name)) as fh:
        return json.load(fh)


def load_point_add_json(dir_path: str):
    d = os.path.join(dir_path, "pointAdd")
    px = [_bytes_to_int(r) for r in _load(d, "point_add_px_byte.json")]
    py = [_bytes_to_int(r) for r in _load(d, "point_add_py_byte.json")]
    rx = [_bytes_to_int(r) for r in _load(d, "point_add_rx_byte.json")]
    ry = [_bytes_to_int(r) for r in _load(d, "point_add_ry_byte.json")]
    rz = [int(v) for v in _load(d, "point_add_rz_byte.json")]
    return px, py, rx, ry, rz


def load_point_mult_json(dir_path: str):
    d = os.path.join(dir_path, "pointMult")
    weights = [int(w) for w in _load(d, "weight.json")]
    px = [_bytes_to_int(r) for r in _load(d, "point_mult_px_byte.json")]
    py = [_bytes_to_int(r) for r in _load(d, "point_mult_py_byte.json")]
    return weights, px, py


@dataclass
class ProofStats:
    size_bytes: int
    gen_ms: int
    ver_ms: int


def _prove_gadget(gadget_out, tape_seed: Optional[int], device,
                  full_snark: bool, ckpt: Optional[CheckpointStore] = None):
    inst, vars_para, vars_input, vars_full, inputs, nc, nv, ni, nnz = gadget_out
    gens = SNARKGens(nc, nv, ni, nnz)
    # SNARK::encode commits to the R1CS matrices, so that the verifier never
    # reads them (reference lib.rs:347-358); it is part of the prove time
    comm = decomm = None
    if full_snark:
        comm, decomm = snark_encode(inst, gens)
    with span("witness_commit"):
        poly_vars, comm_vars, blind_vars, comm_para, comm_input = \
            cp_commit_witness(vars_para, vars_input, vars_full, gens,
                              tape_seed=tape_seed, device=device, ckpt=ckpt)
    pt = Transcript(b"snark_example")
    proof = cp_snark_prove(inst, vars_full, inputs, gens, pt,
                           poly_vars, comm_vars, blind_vars, decomm=decomm,
                           tape_seed=tape_seed, with_eval_proof=full_snark,
                           ckpt=ckpt)
    return proof, inst, inputs, gens, comm_para, comm_input, comm


def _witness_digest(*arrays) -> str:
    """Digest of the witness, so that a checkpoint directory is never
    resumed against another witness of the same shape (which would reuse
    the earlier run's commitments)."""
    h = hashlib.sha256()
    for arr in arrays:
        for v in arr:
            h.update(int(v).to_bytes(33, "little", signed=False))
        h.update(b"|")
    return h.hexdigest()[:32]


def _make_ckpt(ckpt_dir: Optional[str], kind: str, count: int,
               tape_seed: Optional[int], n_bits: int = 0,
               witness_digest: str = "") -> Optional[CheckpointStore]:
    """A CheckpointStore bound to this proof run, or None without a
    directory.  A directory made for another run raises ValueError, and so
    does a checkpointed proof without a tape seed."""
    if ckpt_dir is None:
        return None
    if tape_seed is None:
        raise ValueError("a checkpointed proof needs a deterministic "
                         "tape_seed")
    return CheckpointStore(ckpt_dir, meta={
        "kind": kind, "count": count, "tape_seed": tape_seed,
        "n_bits": n_bits, "witness": witness_digest})


def _prove_and_verify(label: str, build, count: int, tape_seed, quiet,
                      device, full_snark, ckpt=None) -> ProofStats:
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if not quiet:
        print(f"{label} Gadget...")
        print(f"Number of {label}s: {count}")
    with span("gadget"):
        gadget = build(dev)
    proof, inst, inputs, gens, comm_para, comm_input, comm = _prove_gadget(
        gadget, tape_seed, dev, full_snark, ckpt=ckpt)
    synchronize(dev)
    data = serialize_snark(proof)
    size = len(data)
    if RECORD is not None:
        RECORD.append((label, data))
    gen_ms = int((time.perf_counter() - t0) * 1000)
    if not quiet:
        print(f"Proof size: {size} bytes")
        print(f"Proof generation time: {gen_ms} ms")
    t1 = time.perf_counter()
    vt = Transcript(b"snark_example")
    with span("verify"):
        ok = cp_snark_verify(proof, inst, inputs, vt, gens, comm_para,
                             comm_input, comm=comm)
    if not ok:
        raise AssertionError(f"{label.lower()} proof verification failed")
    if not quiet:
        print("Proof verification successful!")
    ver_ms = int((time.perf_counter() - t1) * 1000)
    if not quiet:
        print(f"Proof verification time: {ver_ms} ms")
    return ProofStats(size, gen_ms, ver_ms)


def prove_point_add(px, py, rx, ry, rz, tape_seed=None, quiet=False,
                    device=None, full_snark: bool = True,
                    ckpt_dir: Optional[str] = None) -> ProofStats:
    ckpt = _make_ckpt(ckpt_dir, "point_add", len(px), tape_seed,
                      witness_digest=(_witness_digest(px, py, rx, ry, rz)
                                      if ckpt_dir else ""))
    return _prove_and_verify(
        "Point Addition",
        lambda dev: point_addition_gadget(px, py, rx, ry, rz, device=dev),
        len(px), tape_seed, quiet, device, full_snark, ckpt)


def prove_point_mult(weights, px, py, n_bits=128, tape_seed=None,
                     quiet=False, device=None, full_snark: bool = True,
                     ckpt_dir: Optional[str] = None) -> ProofStats:
    if weights and max(int(w) for w in weights) >= (1 << n_bits):
        # wide rLC-combined FC scalars: the full-width double-and-add
        # circuit (the reference u128 loader would panic, load_data.rs:21-23)
        n_bits = 253
    ckpt = _make_ckpt(ckpt_dir, "point_mult", len(weights), tape_seed,
                      n_bits=n_bits,
                      witness_digest=(_witness_digest(weights, px, py)
                                      if ckpt_dir else ""))
    return _prove_and_verify(
        "Point Multiplication",
        lambda dev: point_mult_gadget(weights, px, py, n=n_bits, device=dev),
        len(weights), tape_seed, quiet, device, full_snark, ckpt)


def _print_totals(stats_add: ProofStats, stats_mult: ProofStats):
    total = (stats_add.size_bytes + stats_mult.size_bytes,
             stats_add.gen_ms + stats_mult.gen_ms,
             stats_add.ver_ms + stats_mult.ver_ms)
    print("\n====================================")
    print(f"Total proof size: {total[0]} bytes")
    print(f"Total proof generation time: {total[1]} ms")
    print(f"Total proof verification time: {total[2]} ms")
    print("====================================")
    return total


def prove_tag_dir(dir_path: str, n_bits=128, tape_seed=None,
                  skip_mult=False, device=None, full_snark: bool = True,
                  ckpt_dir: Optional[str] = None) -> Tuple[int, int, int]:
    """`cargo run -- <tag>` equivalent over a rust_files/<tag> directory.
    ckpt_dir: the base of the proofs' checkpoint directories, <base>/add
    and <base>/mult."""
    stats_add = prove_point_add(*load_point_add_json(dir_path),
                                tape_seed=tape_seed, device=device,
                                full_snark=full_snark,
                                ckpt_dir=(os.path.join(ckpt_dir, "add")
                                          if ckpt_dir else None))
    print("")
    weights = []
    if not skip_mult and os.path.exists(
            os.path.join(dir_path, "pointMult", "weight.json")):
        weights, px, py = load_point_mult_json(dir_path)
    if weights:
        stats_mult = prove_point_mult(weights, px, py, n_bits=n_bits,
                                      tape_seed=tape_seed, device=device,
                                      full_snark=full_snark,
                                      ckpt_dir=(os.path.join(ckpt_dir, "mult")
                                                if ckpt_dir else None))
    else:
        print("Number of Point Multiplications: 0")
        print("Proof size: 0 bytes")
        print("Proof generation time: 0 ms")
        print("Proof verification time: 0 ms")
        stats_mult = ProofStats(0, 0, 0)
    return _print_totals(stats_add, stats_mult)


def trace_args(fin, add_slice=None, mult_slice=None):
    """A finalized WitnessTrace -> the arguments (px, py, rx, ry, rz) of
    prove_point_add and (weights, px, py) of prove_point_mult, each over its
    (start, stop) slice of the trace, or all of it."""
    as_ = slice(*add_slice) if add_slice else slice(None)
    ms = slice(*mult_slice) if mult_slice else slice(None)
    add = tuple([int(v) for v in fin[k][as_]]
                for k in ("add_px", "add_py", "add_rx", "add_ry"))
    add += ([1 if i else 0 for i in fin["add_r_inf"][as_]],)
    mult = tuple([int(v) for v in fin[k][ms]]
                 for k in ("mult_scalars", "mult_px", "mult_py"))
    return add, mult


def prove_trace(trace, n_bits=128, tape_seed=None, mult_slice=None,
                add_slice=None, device=None,
                full_snark: bool = True) -> Tuple[int, int, int]:
    """Prove directly from an in-process WitnessTrace (no JSON round trip)."""
    add, mult = trace_args(trace.finalize(), add_slice, mult_slice)
    stats_add = prove_point_add(*add, tape_seed=tape_seed, device=device,
                                full_snark=full_snark)
    print("")
    if mult[0]:
        stats_mult = prove_point_mult(*mult, n_bits=n_bits,
                                      tape_seed=tape_seed, device=device,
                                      full_snark=full_snark)
    else:
        print("Number of Point Multiplications: 0")
        stats_mult = ProofStats(0, 0, 0)
    return _print_totals(stats_add, stats_mult)
