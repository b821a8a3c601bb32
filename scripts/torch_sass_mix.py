#!/usr/bin/env python3
"""The instruction mix of the port's CUDA kernels, as compiled for sm_90a.

    python3 scripts/torch_sass_mix.py

Builds the kernel sources (vpin_tpu_torch/kernels.py), disassembles each
library with cuobjdump -sass and counts, per kernel function, its SASS
instructions by class: integer multiplies (IMAD*), register moves (MOV),
other integer and logic instructions (IADD3, LOP3, SHF, ...), memory, and
the rest.  Counts are static (each instruction of the code once, loops not
unrolled by the count), so they give the ratio of multiplies to everything
else in a kernel's body, which a bound that counts multiplies alone leaves
out.  Needs the CUDA toolkit; no GPU is used.  The last line is one JSON
object.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CLASSES = (("imad", re.compile(r"^IMAD")),
           ("mov", re.compile(r"^MOV")),
           ("int", re.compile(r"^(IADD|LOP|SHF|SEL|ISETP|PLOP|LEA|IABS|PRMT|ISCADD|IMNMX|FLO|POPC|BMSK|SGXT)")),
           ("memory", re.compile(r"^(LD|ST|LDG|STG|LDS|STS|LDC|ULDC|SHFL|ATOM|RED)")))


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found: needs the CUDA toolkit")


def mix(sass: str) -> dict:
    """{kernel function: Counter of instruction classes} from cuobjdump."""
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            op = m.group(1)
            if op.startswith("NOP"):
                continue
            cls = next((c for c, rx in CLASSES if rx.match(op)), "other")
            out[fn][cls] += 1
    return out


def main() -> int:
    from vpin_tpu_torch import kernels
    kernels.build()
    result = {}
    for name in kernels.SOURCES:
        sass = subprocess.run([cuobjdump(), "-sass",
                               str(kernels.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        for fn, counts in mix(sass).items():
            total = sum(counts.values())
            result[fn] = dict(counts, total=total)
            print(f"{name:14s} {fn[:48]:48s} total {total:6d}  " + "  ".join(
                f"{c} {counts[c]}" for c in ("imad", "mov", "int", "memory",
                                            "other")),
                flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
