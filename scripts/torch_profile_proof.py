#!/usr/bin/env python3
"""Where the CP-SNARK proof of one conv request's witness trace spends its
time in the PyTorch/CUDA port (vpin_tpu_torch), on one GPU.

    python3 scripts/torch_profile_proof.py                 # the full SNARK
    python3 scripts/torch_profile_proof.py --transparent   # no eval proof

Runs one conv3/32x32 request for its trace, one cold proof of it (kernel builds,
the generators' digit tables), then two warm proofs: the first with the
prover's spans recorded (utils/timer.py: host time and kernel launches per
span), the second under torch.profiler.  Prints the wall time and launches
of each span (host clock; a span holds the device work it enqueued up to its
last synchronizing read), for the point-mult gadget alone (its witness scan)
and for the whole proofs, among them the eval proof's SNARK::encode and
R1CSEvalProof::prove; then the device time by kernel name over the profiled
point-mult proof and the device's busy share of its wall time (the
profiler's own host cost is inside that wall time).  The last line is one
JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FILTER = 3
SIZE = 32
TAPE_SEED = 3


def spans(record):
    """{depth:label: [ms, {kernel: launches}]} summed over repeats."""
    out = {}
    for depth, label, dt, launched in record:
        entry = out.setdefault(f"{depth}:{label}", [0.0, {}])
        entry[0] += dt * 1e3
        for k, v in launched.items():
            if v:
                entry[1][k] = entry[1].get(k, 0) + v
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--transparent", action="store_true",
                    help="profile the proof without the eval proof")
    full = not ap.parse_args().transparent
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_profile_proof: no CUDA device", file=sys.stderr)
        return 1
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.gadgets import point_mult_gadget
    from vpin_tpu_torch.nn.elgamal import KeyPair
    from vpin_tpu_torch.nn.models import run_conv_workload
    from vpin_tpu_torch.runner.proof_runner import (
        prove_point_add, prove_point_mult, trace_args,
    )
    from vpin_tpu_torch.utils import timer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    key = KeyPair.generate(random.Random(0), device=dev)
    img = np.random.RandomState(0).uniform(0.0, 1.0, (SIZE, SIZE)
                                           ).astype(np.float32)
    res = run_conv_workload(img, FILTER, key, random.Random(1))
    add, mult = trace_args(res.trace.finalize())

    kw = dict(tape_seed=TAPE_SEED, quiet=True, device=dev, full_snark=full)
    t = time.perf_counter()
    cold_add = prove_point_add(*add, **kw)
    cold_mult = prove_point_mult(*mult, **kw)
    print(f"cold proof: {(time.perf_counter() - t) * 1e3:.1f} ms; "
          f"add {cold_add}, mult {cold_mult}", flush=True)

    def counted(fn):
        for name in kernels.LAUNCHES:
            kernels.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3, dict(kernels.LAUNCHES)

    _, gadget_ms, gadget_launches = counted(
        lambda: point_mult_gadget(*mult, device=dev))
    timer.RECORD = []
    warm_add, _, add_launches = counted(lambda: prove_point_add(*add, **kw))
    add_spans = spans(timer.RECORD)
    timer.RECORD = []
    warm_mult, mult_ms, mult_launches = counted(
        lambda: prove_point_mult(*mult, **kw))
    mult_spans = spans(timer.RECORD)
    timer.RECORD = None

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_mult = prove_point_mult(*mult, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3

    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            name = ev.key.split("(")[0][:120]
            by_kernel[name] = by_kernel.get(name, 0.0) \
                + ev.self_device_time_total / 1e3
    device_ms = sum(by_kernel.values())
    print(f"point-mult gadget alone: {gadget_ms:.1f} ms, launches "
          f"{gadget_launches}", flush=True)
    print(f"warm add proof: {warm_add}; launches {add_launches}; spans (ms) "
          f"{add_spans}", flush=True)
    print(f"warm mult proof: {warm_mult}, {mult_ms:.1f} ms with verification; "
          f"launches {mult_launches}; spans (ms):", flush=True)
    for k, (v, n) in mult_spans.items():
        print(f"  {v:10.1f}  {k}  {n}", flush=True)
    print(f"profiled mult proof: {prof_mult}; device time by kernel (ms, "
          f"total {device_ms:.3f} of {wall_ms:.3f} ms wall):", flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:10.3f}  {name}", flush=True)
    print(json.dumps({
        "card": card, "size": SIZE, "filter": FILTER, "full_snark": full,
        "cold_add": cold_add.__dict__, "cold_mult": cold_mult.__dict__,
        "gadget_ms": gadget_ms, "gadget_launches": gadget_launches,
        "warm_add": warm_add.__dict__, "add_launches": add_launches,
        "add_spans_ms": add_spans, "warm_mult": warm_mult.__dict__,
        "mult_ms": mult_ms, "mult_launches": mult_launches,
        "mult_spans_ms": mult_spans, "profiled_mult": prof_mult.__dict__,
        "profiled_wall_ms": wall_ms, "device_ms_by_kernel": by_kernel,
        "device_busy_share": device_ms / wall_ms if wall_ms else None}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
