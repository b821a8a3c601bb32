#!/usr/bin/env python3
"""Time the full-SNARK proof of the 16 point additions of one conv request
in the PyTorch/CUDA port (vpin_tpu_torch) with its tables on each route, on
one GPU.

    python3 scripts/torch_spark_routes.py [--repeats 3]

Runs one conv3/32x32 request for its trace, then proves its 16 point
additions with the full SNARK (tape seed 3) in two settings:
  default  the SPARK eval proof on Montgomery tensors (kernels K1, K4), the
           sat proof's tables under HOST_POLY_MAX on host ints;
  all      HOST_POLY_MAX = 0: every table on tensors.
Each setting is proven once untimed (digit tables, first launches), then the
settings take turns, ``--repeats`` rounds.  Prints, for every proof, the
prove and verify times, the spans SNARK::encode and R1CSEvalProof::prove
(host clock, ending in the proof's synchronize) with their kernel launches,
and the proof's size; then the median of each setting.  The last line is
one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FILTER = 3
SIZE = 32
TAPE_SEED = 3
SPANS = ("SNARK::encode", "R1CSEvalProof::prove")
SETTINGS = ("default", "all")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    repeats = ap.parse_args().repeats
    import torch
    if not torch.cuda.is_available():
        print("torch_spark_routes: no CUDA device", file=sys.stderr)
        return 1
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.nn.elgamal import KeyPair
    from vpin_tpu_torch.nn.models import run_conv_workload
    from vpin_tpu_torch.poly import dense
    from vpin_tpu_torch.runner.proof_runner import prove_point_add, trace_args
    from vpin_tpu_torch.utils import timer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    key = KeyPair.generate(random.Random(0), device=dev)
    img = np.random.RandomState(0).uniform(0.0, 1.0, (SIZE, SIZE)
                                           ).astype(np.float32)
    add, _ = trace_args(run_conv_workload(img, FILTER, key,
                                          random.Random(1)).trace.finalize())

    host_poly_max = dense.HOST_POLY_MAX

    def prove(setting: str) -> dict:
        dense.HOST_POLY_MAX = 0 if setting == "all" else host_poly_max
        for name in kernels.LAUNCHES:
            kernels.LAUNCHES[name] = 0
        timer.RECORD = []
        try:
            st = prove_point_add(*add, tape_seed=TAPE_SEED, quiet=True,
                                 device=dev)
            record = timer.RECORD
        finally:
            timer.RECORD = None
            dense.HOST_POLY_MAX = host_poly_max
        spans = {label: [0.0, {}] for label in SPANS}
        for _, label, dt, launched in record:
            if label in spans:
                spans[label][0] += dt * 1e3
                for k, v in launched.items():
                    if v:
                        spans[label][1][k] = spans[label][1].get(k, 0) + v
        return dict(setting=setting, size=st.size_bytes, prove_ms=st.gen_ms,
                    verify_ms=st.ver_ms, launches=dict(kernels.LAUNCHES),
                    spans_ms={k: v[0] for k, v in spans.items()},
                    span_launches={k: v[1] for k, v in spans.items()})

    for setting in SETTINGS:
        out = prove(setting)
        print(f"untimed {setting}: {out['size']} B, prove {out['prove_ms']} "
              f"ms", flush=True)
    runs = []
    for r in range(repeats):
        for setting in SETTINGS:
            out = prove(setting)
            runs.append(out)
            print(f"round {r} {setting}: {out['size']} B, prove "
                  f"{out['prove_ms']} ms, verify {out['verify_ms']} ms; "
                  + "; ".join(f"{k} {out['spans_ms'][k]:.1f} ms "
                              f"{out['span_launches'][k]}" for k in SPANS),
                  flush=True)
    sizes = {out["size"] for out in runs}
    if len(sizes) != 1:
        print(f"torch_spark_routes: proof sizes differ: {sizes}",
              file=sys.stderr)
        return 1
    medians = {}
    for setting in SETTINGS:
        mine = [out for out in runs if out["setting"] == setting]
        medians[setting] = {
            "prove_ms": statistics.median(o["prove_ms"] for o in mine),
            **{k: statistics.median(o["spans_ms"][k] for o in mine)
               for k in SPANS}}
        print(f"median {setting}: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in medians[setting].items()),
            flush=True)
    print(json.dumps({"card": card, "size": sizes.pop(), "runs": runs,
                      "medians_ms": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
