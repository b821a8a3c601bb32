#!/usr/bin/env python3
"""Kill a checkpointed `cli mult-scale` proof mid-way and resume it.

Runs `python -m vpin_tpu_torch.runner.cli mult-scale --mults N --transparent`
three times, each as its own process on the GPU (unless ``--device cpu``):
  1. uninterrupted, without checkpoints;
  2. with ``--ckpt DIR``, SIGKILLed as soon as the snapshot ``--kill-at``
     (default sc1, the first sumcheck's) is on disk;
  3. with the same ``--ckpt DIR`` again, which resumes from the snapshots.
Runs 1 and 3 must report the same proof size and both verify.  Prints each
run's wall time and the CLI's proof lines, then one JSON line.  The
checkpoint directory is removed at the start and the end.

    python3 scripts/torch_ckpt_resume.py --mults 1000
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def cli(args, extra):
    return [sys.executable, "-m", "vpin_tpu_torch.runner.cli", "mult-scale",
            "--mults", str(args.mults), "--seed", str(args.seed),
            "--transparent", "--device", args.device] + extra


def proof_lines(out: str) -> dict:
    got = {}
    for line in out.splitlines():
        for key in ("Proof size", "Proof generation time",
                    "Proof verification time"):
            if line.startswith(key + ":"):
                got[key] = int(line.split(":")[1].split()[0])
    if "Proof verification successful!" not in out:
        raise SystemExit("the proof did not verify:\n" + out[-2000:])
    return got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mults", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill-at", default="sc1")
    ap.add_argument("--ckpt", default=os.path.join(REPO, "ckpt_mult_scale"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    shutil.rmtree(args.ckpt, ignore_errors=True)
    rec = {"mults": args.mults, "kill_at": args.kill_at}

    t0 = time.perf_counter()
    run = subprocess.run(cli(args, []), env=env, capture_output=True,
                         text=True, cwd=REPO)
    rec["uninterrupted_s"] = time.perf_counter() - t0
    if run.returncode:
        raise SystemExit(run.stderr[-4000:])
    rec["uninterrupted"] = proof_lines(run.stdout)
    print(run.stdout, flush=True)

    snap = os.path.join(args.ckpt, args.kill_at + ".pkl")
    t0 = time.perf_counter()
    child = subprocess.Popen(cli(args, ["--ckpt", args.ckpt]), env=env,
                             stdout=subprocess.DEVNULL, cwd=REPO)
    while not os.path.exists(snap):
        if child.poll() is not None:
            raise SystemExit(f"the child ended ({child.returncode}) before "
                             f"{snap} appeared")
        time.sleep(0.05)
    child.send_signal(signal.SIGKILL)
    child.wait()
    rec["killed_after_s"] = time.perf_counter() - t0
    rec["snapshots_at_kill"] = sorted(os.listdir(args.ckpt))

    t0 = time.perf_counter()
    run = subprocess.run(cli(args, ["--ckpt", args.ckpt]), env=env,
                         capture_output=True, text=True, cwd=REPO)
    rec["resumed_s"] = time.perf_counter() - t0
    if run.returncode:
        raise SystemExit(run.stderr[-4000:])
    rec["resumed"] = proof_lines(run.stdout)
    print(run.stdout, flush=True)
    shutil.rmtree(args.ckpt, ignore_errors=True)
    if rec["resumed"]["Proof size"] != rec["uninterrupted"]["Proof size"]:
        raise SystemExit(f"proof sizes differ: {rec}")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
