#!/usr/bin/env python3
"""Where a warm conv request of the PyTorch/CUDA port (vpin_tpu_torch) spends
its time, on one GPU.

    python3 scripts/torch_profile_conv.py [--size 32] [--filter 3] [--requests 2]

Runs one cold request (kernel build, fixed-base tables), then ``--requests``
warm ones under torch.profiler.  Prints for each warm request its wall time
per phase (host clock, each phase ending in a device synchronize; the
profiler's own cost is inside these, chip_smoke.py has them without it), the
device time by kernel name summed over the warm requests, the launches of
each kernel, and the device's busy share of the warm requests' wall time.
The last line is one JSON object with the same numbers.
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


def request(key, img, filt, seed, sync):
    from vpin_tpu_torch.nn.models import run_conv_workload
    t0 = time.perf_counter()
    res = run_conv_workload(img, filt, key, random.Random(seed),
                            defer_checks=True)
    t1 = time.perf_counter()
    res.flush_checks()
    t2 = time.perf_counter()
    res.trace.finalize()
    sync()
    t3 = time.perf_counter()
    return {"encrypt_ms": res.timings["encrypt"] * 1e3,
            "conv_ms": res.timings["inference"] * 1e3,
            "rlc_flush_ms": (t2 - t1) * 1e3, "finalize_ms": (t3 - t2) * 1e3,
            "request_ms": (t3 - t0) * 1e3}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--filter", type=int, default=3)
    p.add_argument("--requests", type=int, default=2)
    args = p.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_profile_conv: no CUDA device", file=sys.stderr)
        return 1
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.nn.elgamal import KeyPair

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    key = KeyPair.generate(random.Random(0), device=dev)
    img = np.random.RandomState(0).uniform(0.0, 1.0, (args.size, args.size)
                                           ).astype(np.float32)
    print("cold request: " + json.dumps(request(key, img, args.filter, 1, sync)),
          flush=True)

    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    warm = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in range(args.requests):
            warm.append(request(key, img, args.filter, 2 + r, sync))
            print(f"warm request {r}: " + json.dumps(warm[-1]), flush=True)
    launches = dict(kernels.LAUNCHES)

    # device-side events only (kernels and copies); their parents on the host
    # carry the same time again.  Names are cut before their argument lists.
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            name = ev.key.split("(")[0][:120]
            by_kernel[name] = by_kernel.get(name, 0.0) \
                + ev.self_device_time_total / 1e3
    wall_ms = sum(w["request_ms"] for w in warm)
    device_ms = sum(by_kernel.values())
    print(f"device time by kernel over {args.requests} warm requests "
          f"(ms, total {device_ms:.3f} of {wall_ms:.3f} ms wall):", flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms:10.3f}  {name}", flush=True)
    print(f"launches: {launches}", flush=True)
    print(json.dumps({"card": card, "size": args.size, "filter": args.filter,
                      "warm_requests": warm, "device_ms_by_kernel": by_kernel,
                      "device_busy_share": device_ms / wall_ms if wall_ms else None,
                      "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
