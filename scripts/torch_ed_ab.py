#!/usr/bin/env python3
"""K5 of several trees side by side on one GPU, in turns.

    python3 scripts/torch_ed_ab.py [--repeats N] [--ladders N,N,...] TREE ...

Each TREE is a checkout of the repo (for example a parent commit unpacked
with git archive into a directory that .gitignore lists, or "." for this
one).  For each, in the order given, a process of its own builds that
tree's kernel sources, prints the K5 library's registers, spills and shared
memory and a hash of the SASS of each library (cuobjdump -sass, its
instructions alone, in order: two trees whose kernels compile to the same
code show the same hash, whatever the kernels' parameter types are named),
then runs that tree's K5 wrapper on 253-bit ladders (by default 8,
1,024, 4,096, 8,192 and 16,384 of them, with the inputs of chip_smoke.py's
check_ed_ladder) with every lane count the tree offers (its
cuda_edwards.LADDER_LANES; a tree without them runs its one kernel), each
variant first held
bit for bit against that tree's ed_ladder_plain.  Times are CUDA events
over 3 launches queued behind a sleep kernel, N samples (default 7) per
variant.  Give a tree twice, as in parent, change, change, parent: the
summary then lists, per shape and variant, each turn's median and the
median, minimum and maximum of all its samples.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

CODE = r'''
import hashlib, json, re, shutil, statistics, subprocess, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from vpin_tpu_torch import kernels
from vpin_tpu_torch.curve import cuda_edwards
from vpin_tpu_torch.curve.ristretto import RISTRETTO as R
from vpin_tpu_torch.curve.weierstrass import pack_bits
from vpin_tpu_torch.field.limbs import to_tensor
tree, repeats = sys.argv[1], int(sys.argv[2])
SHAPES = tuple((int(n), 253) for n in sys.argv[3].split(","))
card = cs.smi("name,power.limit")
cs.log(f"{card} | tree {tree}")
logs = kernels.build()
for line in logs["ed_ladder"].splitlines():
    if "registers" in line or "spill" in line or "Compiling" in line:
        cs.log(f"  ed_ladder: {line.strip()}")
tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
sass = {}
for name in kernels.SOURCES:
    text = subprocess.run([tool, "-sass", str(kernels.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    keep = [l.split(";")[0].strip() for l in text.splitlines()
            if re.match(r"\s*/\*[0-9a-f]{4,}\*/", l)]
    sass[name] = hashlib.sha256("\n".join(keep).encode()).hexdigest()[:16]
cs.log(f"  SASS hashes: {sass}")
dev = torch.device("cuda")
variants = getattr(cuda_edwards, "LADDER_LANES", (None,))


def samples(fn):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 3)
    return out


times = {}
for n, n_bits in SHAPES:
    P, _ = cs.edwards_points(torch, dev, max(n, 64), 20 + n % 7)
    P = tuple(c[:n].contiguous() for c in P)
    rows = np.random.RandomState(n).randint(0, 2, size=(n, n_bits)
                                            ).astype(np.uint8)
    words = to_tensor(pack_bits(rows), dev)
    want = cuda_edwards.ed_ladder_plain(R, P, words, n_bits, 1, n)
    for g in variants:
        kw = {} if g is None else {"_lanes": g}
        call = lambda: cuda_edwards.ed_ladder(R, P, words, n_bits, 1, n, **kw)
        got = call()
        torch.cuda.synchronize()
        cs.require(all(torch.equal(a, b) for a, b in zip(got, want)),
                   f"tree {tree}: ed_ladder {n} lanes={g}: kernel != plain")
        label = "1 thread" if g in (None, 1) else f"{g} lanes"
        ts = samples(call)
        times.setdefault(str(n), {})[label] = ts
        cs.log(f"  K5 {n} x {n_bits}, {label}: bit-equal to plain; median "
               f"{statistics.median(ts):.4f} ms ({min(ts):.4f}-"
               f"{max(ts):.4f})")
print(json.dumps({"tree": tree, "card": card, "sass": sass,
                  "times": times}), flush=True)
'''


def main() -> int:
    args = sys.argv[1:]
    opts = {"--repeats": "7", "--ladders": "8,1024,4096,8192,16384"}
    while args[:1] and args[0] in opts:
        opts[args[0]], args = args[1], args[2:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in args:
        proc = subprocess.run([sys.executable, "-c", CODE, tree,
                               opts["--repeats"], opts["--ladders"]],
                              cwd=tree, stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.splitlines()
        print("\n".join(l for l in lines if not l.startswith("{")),
              flush=True)
        if proc.returncode:
            return proc.returncode
        runs.append(json.loads(next(l for l in reversed(lines)
                                    if l.startswith("{"))))
    print("summary, ms (each turn's median; median, min-max of all samples):")
    for tree in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == tree]
        print(f"tree {tree}: SASS {mine[0]['sass']}")
        for n, by in mine[0]["times"].items():
            for label in by:
                turns = [r["times"][n][label] for r in mine]
                every = [t for ts in turns for t in ts]
                print(f"  {n:>5} x 253, {label}: turns "
                      + ", ".join(f"{statistics.median(ts):.4f}"
                                  for ts in turns)
                      + f"; all {statistics.median(every):.4f} "
                        f"({min(every):.4f}-{max(every):.4f})")
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
