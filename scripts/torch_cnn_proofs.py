#!/usr/bin/env python3
"""Prove CNN A-E's whole traces with the full SNARK on the PyTorch/CUDA port.

vpin_tpu's `cli cnn --prove` proves a CNN request's trace with the full
SNARK (vpin_tpu/runner/cli.py:204-205).  This script serves one request of
each version given at 32x32 on the GPU (key and image from seed 0, stand-in
weights from seed 0, nonces from seed 1, the reference's m = 3,200,000 BSGS
table built on the card), then proves the trace's point-add and point-mult
instances with the full SNARK (the sat proof and the SPARK eval proof of
their matrices; tape seed 3; the 253-bit mult gadget where an rLC-combined
FC scalar needs more than 128 bits) under the prover's default memory
bounding, and verifies each on the host.  Each proof's size must equal its
bincode length and what its instance's shape gives
(utils/bincode.snark_size).

It prints the card's name and power limit, then one JSON line per version:
mults, adds, each proof's constraints, bytes, prove and verify ms, and the
card's peak over both proofs.  A version whose
proof runs out of card memory prints the stages open when it did and the
peak so far, and the script goes on to the next version.  With ``--spans``
each version's stages follow as a table (scripts/torch_layer_memory.py's
PeakSpans).  It writes no file.

    python3 scripts/torch_cnn_proofs.py --versions A,B,C,D,E
"""

import argparse
import json
import os
import random
import subprocess
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_layer_memory import PeakSpans  # noqa: E402

BSGS_M = 3_200_000
TAPE_SEED = 3


class StageSpans(PeakSpans):
    """PeakSpans that also remembers which stages were open when the card
    ran out of memory."""

    def __init__(self, torch, dev):
        super().__init__(torch, dev)
        self.names, self.failed = [], None

    def _wrap(self, name, fn):
        inner = super()._wrap(name, fn)

        def wrapper(*args, **kwargs):
            self.names.append(name)
            try:
                return inner(*args, **kwargs)
            except self.torch.cuda.OutOfMemoryError:
                if self.failed is None:
                    self.failed = list(self.names)
                raise
            finally:
                self.names.pop()
        return wrapper


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--versions", default="A,B,C,D,E")
    ap.add_argument("--spans", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_cnn_proofs: no CUDA device", file=sys.stderr)
        return 1
    from vpin_tpu_torch.gadgets import point_addition, point_mult
    from vpin_tpu_torch.nn.bsgs import BsgsTable
    from vpin_tpu_torch.nn.elgamal import KeyPair
    from vpin_tpu_torch.nn.models import (
        CNN_CONFIGS, make_random_weights, run_cnn_workload,
    )
    from vpin_tpu_torch.runner import proof_runner as pr
    from vpin_tpu_torch.utils.bincode import snark_size

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    table = BsgsTable.build(BSGS_M, device=dev)
    key = KeyPair.generate(random.Random(0), device=dev)
    img = np.random.RandomState(0).uniform(0.0, 1.0, (32, 32)).astype(
        np.float32)
    for v in (x.strip() for x in args.versions.split(",")):
        fc1_in, fc1_out, _, _ = CNN_CONFIGS[v]
        res = run_cnn_workload(v, img, key, table,
                               weights=make_random_weights(fc1_in, fc1_out,
                                                           seed=0),
                               rng=random.Random(1))
        add, mult = pr.trace_args(res.trace.finalize())
        del res
        n_bits = 253 if max(mult[0]) >= 1 << 128 else 128
        rec = {"version": v, "mults": len(mult[0]), "adds": len(add[0]),
               "mult_gadget_bits": n_bits}
        spans = StageSpans(torch, dev)
        spans.install()
        torch.cuda.synchronize(dev)
        spans.enter()
        pr.RECORD = []
        t0 = time.perf_counter()
        try:
            for label, build, prove, args_ in (
                    ("add", point_addition.build_matrices,
                     pr.prove_point_add, add),
                    ("mult", lambda n: point_mult.build_matrices(n, n_bits),
                     pr.prove_point_mult, mult)):
                A, B, C, nc, nv, *_ = build(len(args_[0]))
                want = snark_size(nc, nv, max(len(A[0]), len(B[0]), len(C[0])),
                                  True)
                del A, B, C
                st = prove(*args_, tape_seed=TAPE_SEED, quiet=True,
                           device=dev, full_snark=True)
                blob = pr.RECORD[-1][1]
                if not st.size_bytes == len(blob) == want:
                    raise SystemExit(f"CNN {v} {label}: {st.size_bytes} B, "
                                     f"bincode {len(blob)}, its shape gives "
                                     f"{want}")
                rec[label] = {"constraints": nc, "proof_bytes": st.size_bytes,
                              "prove_ms": st.gen_ms, "verify_ms": st.ver_ms}
        except torch.cuda.OutOfMemoryError as e:
            rec["out_of_memory"] = {"stages": spans.failed,
                                    "error": str(e).splitlines()[0]}
        finally:
            pr.RECORD = None
            peak = spans.leave()
            spans.remove()
        rec["wall_s"] = round(time.perf_counter() - t0, 3)
        rec["device_peak_gb"] = peak / 1e9
        print(json.dumps(rec), flush=True)
        if args.spans:
            print(spans.table(), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
