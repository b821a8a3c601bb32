"""The control of each cell: a run whose output must come out as not
correct, which shows that the comparison can fail.

    python3 -m benchmark.control --workload <cell> --seeds a,b,c [--seconds s]

Serving cells: the window's requests are compared with the reference
computed one fixed-point bit below the configuration's precision (15
fraction bits for 16), the nearest lower precision of this integer
pipeline.  Proof cells: the prover is handed a witness with its first value
moved by one, which breaks the guarantee that a proof is of the recorded
witness.  Each seed runs in its own process, as the benchmark's runs do;
each prints the run's line, whose ``correct`` must be false.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from . import cells


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    bench = cells.benchmark()
    seconds = args.seconds or bench["run_seconds"]
    if args.seed is not None:                  # one seed, in this process
        from .run import run_cell
        line = run_cell(bench, args.workload, args.seed, seconds, False,
                        control=True)
        print(json.dumps(line), flush=True)
        return 0
    bad = 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = subprocess.run([sys.executable, "-m", "benchmark.control",
                            "--workload", args.workload, "--seed", str(seed),
                            "--seconds", str(seconds)],
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if not lines:
            print(f"{args.workload} seed {seed}: no line (rc {r.returncode})"
                  f"\n{r.stderr[-2000:]}")
            bad += 1
            continue
        line = json.loads(lines[-1])
        bad += int(line["correct"])
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
