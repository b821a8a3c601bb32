#!/usr/bin/env python3
"""K2 and K3 of several trees side by side on one GPU, in turns.

    python3 scripts/torch_e2_ab.py [--passes N] TREE [TREE ...]

Each TREE is a checkout of the repo (for example a parent commit unpacked
with git archive into a directory that .gitignore lists, or "." for this
one).  For each, in the order given, a process of its own builds that
tree's e2_add and e2_scalar_mul sources, prints their registers, spills and
shared memory, then runs that tree's chip_smoke.py checks of K2 (every
batch the main path launches, each entry and lane count against the plain
version, CUDA-event times) and of K3 at the conv's four shapes and with no
bits.  With --passes N each entry and lane count is held against the plain
version on N launches at every shape instead of one, to look for results
that differ between launches.  Give a tree twice, as in parent, change,
change, parent, to see the spread.
"""

from __future__ import annotations

import subprocess
import sys

CODE = r'''
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from vpin_tpu_torch import kernels
passes = int(sys.argv[2])
cs.log(cs.smi("name,power.limit") + f" | tree {sys.argv[1]}, {passes} passes")
logs = kernels.build(["e2_add", "e2_scalar_mul"])
for name, text in logs.items():
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            cs.log(f"  {name}: {line.strip()}")
dev = torch.device("cuda")
props = torch.cuda.get_device_properties(dev)
rate = (cs.MUL32_PER_CLOCK_PER_SM * props.multi_processor_count
        * float(cs.smi("clocks.max.sm").split()[0]) * 1e6)
P = cs.check_e2_add(torch, dev, rate, passes=passes)[-1]
M, f2 = cs.SIZE * cs.SIZE, cs.FILTER * cs.FILTER
for args in ((M * f2, 128, f2, M, "rho over windows"),
             (M, 128, 1, M, "rho over outputs"),
             (M * f2, 2, 1, f2, "filter weights"),
             (f2, 2, 1, f2, "the recorded mults"),
             (M - 1, 128, 1, M - 1, "odd n"),
             (13, 0, 1, 13, "no bits")):
    cs.check_ladder(torch, dev, rate, P, *args, passes=passes)
'''


def main() -> int:
    args = sys.argv[1:]
    passes = "1"
    if args[:1] == ["--passes"]:
        passes, args = args[1], args[2:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in args:
        rc = subprocess.run([sys.executable, "-c", CODE, tree, passes],
                            cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
