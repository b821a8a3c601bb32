"""Run cells several times in a row, each run its own process, and sum up
the spread of each metric: what a bound is set from.

    python3 -m benchmark.sets --cells conv3.prove_add,cnn_a.serve_32 \\
        --seeds 11,12,13 [--seconds 50] [--trace 0] [--out sets.jsonl]

Each run is ``python3 -m benchmark.run`` with the same arguments the check
uses; its result line (or its exit code and the end of its stderr) goes to
``--out``, one JSON object a run.  The summary on stdout gives each metric's
median and its spread: the distance between the first and the third
quartile (statistics.quantiles(values, n=4)) over the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from . import cells


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.sets")
    p.add_argument("--cells", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default="sets.jsonl")
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args(argv)
    bench = cells.benchmark()
    seconds = args.seconds or bench["run_seconds"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    summary = {}
    for name in args.cells.split(","):
        for seed in [int(s) for s in args.seeds.split(",")]:
            cmd = [sys.executable, "-m", "benchmark.run", "--workload", name,
                   "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(args.trace)]
            t = time.perf_counter()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout)
                rc, stdout, stderr = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
                stdout = stdout if isinstance(stdout, str) else stdout.decode()
                stderr = stderr if isinstance(stderr, str) else stderr.decode()
            wall = time.perf_counter() - t
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            rec = {"cell": name, "seed": seed, "trace": args.trace, "rc": rc,
                   "wall_s": wall}
            if lines:
                rec["line"] = json.loads(lines[-1])
            else:
                rec["stderr"] = stderr[-3000:]
            with out.open("a") as fh:
                fh.write(json.dumps(rec) + "\n")
            line = rec.get("line", {})
            print(f"{name} seed {seed} rc {rc} wall {wall:.1f} s correct "
                  f"{line.get('correct')} attempted {line.get('attempted')} "
                  + " ".join(f"{k}={v['value']:.6g}" for k, v in
                             line.get("metrics", {}).items()), flush=True)
            if not lines:
                print(stderr[-1500:], flush=True)
            for k, v in line.get("metrics", {}).items():
                summary.setdefault((name, k), []).append(v["value"])
    for (name, k), vals in summary.items():
        s = spread(vals)
        print(f"SUMMARY {name} {k} n={len(vals)} median="
              f"{statistics.median(vals):.6g} spread="
              f"{'-' if s is None else f'{100 * s:.3f}%'} values="
              + ",".join(f"{v:.6g}" for v in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
