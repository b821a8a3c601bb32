"""The sharded prover end to end: the point-mult CP-SNARK proven without a
mesh and under one, both verified on the host, their bytes required equal.

Port of vpin_tpu's dryrun_multichip (__graft_entry__.py:45-123): the
reference's dominant circuit (27n+8 constraints per mult, point_mult.rs:
61-62) at its real width n = 128, two mults (6,928 constraints, padded to
8,192), transparent, tape seed 7.  Under the mesh every table is a tensor
(poly/dense.host_tables_wanted), so the Hyrax rows, the sumcheck rounds and
binds and the R1CS products all go through parallel/ops.py.
chip_smoke.py phase 9 runs it on Mesh((cuda:0,) * 4), and on
default_mesh() where there are several cards.
"""

from __future__ import annotations

import random
import time

from ..curve.host_ec import E2_G_HOST, E2_ORDER
from ..device import resolve_device, synchronize
from ..gadgets.point_mult import point_mult_gadget
from ..snark import SNARKGens, cp_commit_witness, cp_snark_prove, cp_snark_verify
from ..transcript.merlin import Transcript
from ..utils.bincode import serialize_snark
from .mesh import Mesh, use_mesh
from .ops import ENGAGED

N_MULTS = 2
TAPE_SEED = 7


def make_mult_trace(n_mults: int, n_bits: int = 128):
    """(weights, px, py) of n_mults seeded mults (random.Random(41))."""
    rng = random.Random(41)
    ws, px, py = [], [], []
    for _ in range(n_mults):
        ws.append(rng.randrange(1, 1 << n_bits))
        P1 = rng.randrange(1, E2_ORDER) * E2_G_HOST
        px.append(P1.x)
        py.append(P1.y)
    return ws, px, py


def prove_once(gadget, gens: SNARKGens, tape_seed: int, device):
    """The transparent CP-SNARK of a gadget's output and its host check:
    (proof, verified)."""
    inst, vp, vi, vf, inputs, *_ = gadget
    poly_vars, comm_vars, blind_vars, comm_para, comm_input = \
        cp_commit_witness(vp, vi, vf, gens, tape_seed=tape_seed,
                          device=device)
    proof = cp_snark_prove(inst, vf, inputs, gens,
                           Transcript(b"snark_example"), poly_vars,
                           comm_vars, blind_vars, tape_seed=tape_seed)
    ok = cp_snark_verify(proof, inst, inputs, Transcript(b"snark_example"),
                         gens, comm_para, comm_input)
    return proof, ok


def dryrun_multichip(mesh: Mesh, device=None, n_mults: int = N_MULTS,
                     log=None) -> dict:
    """Prove the mult trace without a mesh and under ``mesh`` on ``device``
    (the GPU unless named).  Raises unless both proofs verify and their
    bytes are equal.  Returns the proof's size, both proving times and the
    sharded entries' engaged calls."""
    dev = resolve_device(device)
    say = log or (lambda msg: None)
    trace = make_mult_trace(n_mults)

    t0 = time.perf_counter()
    gadget = point_mult_gadget(*trace, device=dev)
    nc, nv, ni, nnz = gadget[5:9]
    gens = SNARKGens(nc, nv, ni, nnz)
    proof, ok = prove_once(gadget, gens, TAPE_SEED, dev)
    synchronize(dev)
    single_s = time.perf_counter() - t0
    if not ok:
        raise RuntimeError("the single-device CP-SNARK did not verify")
    want = serialize_snark(proof)
    say(f"single-device proof: {nc} constraints, {len(want)} B, "
        f"{single_s:.1f} s")

    before = dict(ENGAGED)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        gadget = point_mult_gadget(*trace, device=dev)
        proof, ok = prove_once(gadget, gens, TAPE_SEED, dev)
    synchronize(dev)
    mesh_s = time.perf_counter() - t0
    engaged = {k: ENGAGED[k] - before[k] for k in ENGAGED}
    if not ok:
        raise RuntimeError(f"the CP-SNARK sharded over {mesh} did not verify")
    got = serialize_snark(proof)
    if got != want:
        raise RuntimeError(f"the proof sharded over {mesh} differs from the "
                           "single-device proof")
    say(f"sharded proof over {mesh}: {len(got)} B, equal to the "
        f"single-device bytes, {mesh_s:.1f} s; engaged {engaged}")
    return {"constraints": nc, "proof_bytes": len(got), "single_s": single_s,
            "mesh_s": mesh_s, "engaged": engaged}

