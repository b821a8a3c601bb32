"""The port's headline benchmark: conv3/32x32 encrypted inference and its
proofs, end to end, on the card.

    python -m vpin_tpu_torch.runner.bench [size] [--device cuda|cpu]

Port of the repo's bench.py, which drives vpin_tpu.  It runs the
reference's E3 workload, one 3x3 conv on a size x size image (default 32):
ElGamal encryption, the homomorphic conv with its rLC witness check, the
point-add CP-SNARK with the SPARK eval proof and the point-mult CP-SNARK
(transparent unless VPIN_BENCH_MULT_EVAL=1), each verified on the host.
The metric is bench.py's, ``conv3_32x32_e2e_inference_plus_proof``: the
warm request with its rLC check plus both proof phases (each proof's phase
includes its host verification, as in bench.py), in seconds, with
``vs_baseline`` = 120 s (the reference's E3 envelope floor) / value.

Phases, each timed up to a device synchronize:
  kernel_build_s     nvcc builds of the kernels not built yet, every kernel
                     library loaded, the transcript's C core built
  inference_cold_s   the first request (fixed-base tables, rLC set-up and
                     first allocations included)
  inference_warm_s   a second request, plus rlc_check_s (its rLC check)
  prove_add_s        the 16-add proof (proof_add_bytes, verify_add_s)
  prove_mult_s       the 18-mult proof (proof_mult_bytes, verify_mult_s)
  msm4096_table_ms   one table MSM of 4,096 points (ed_msm), after an
                     untimed one that builds the table (ed_table)
  synthetic_2^k_*    with VPIN_BENCH_SYNTH=k: the stock SNARK on a
                     synthetic 2^k instance

Knobs (bench.py's):
  VPIN_BENCH_DEADLINE_S   the watchdog emits the line by then (default 195)
  VPIN_BENCH_PROVE=0      skip the proofs
  VPIN_BENCH_MULT_EVAL=1  the point-mult proof with the SPARK eval proof
  VPIN_BENCH_MSM=0        skip the MSM microbenchmark
  VPIN_BENCH_SYNTH=k      also prove a synthetic 2^k stock SNARK

One JSON line on stdout, logs on stderr.  A phase that fails records
error_<phase> and partial, and the phases that do not need it still run; a
phase skipped for the deadline records partial.  Exit code 0 only when
every phase that ran succeeded and the line is not partial; 1 after a
failure (no CUDA device without ``--device cpu`` among them); 2 when the
deadline cut the run (the watchdog emitted the line, or a phase was
skipped).  Nothing falls back to the CPU or to a plain version.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

from .. import kernels
from ..commit.pedersen import MultiCommitGens
from ..curve.msm import host_digits
from ..device import resolve_device, synchronize
from ..field.prime_field import L_MODULUS
from ..nn.elgamal import KeyPair
from ..nn.models import run_conv_workload
from ..snark.stock import snark_prove_synthetic
from ..transcript import _native
from .proof_runner import prove_point_add, prove_point_mult, trace_args

METRIC = "conv3_32x32_e2e_inference_plus_proof"
BASELINE_S = 120.0
DEADLINE_S = 195.0
FILTER = 3
TAPE_SEED = 3
MSM_N = 4096
# the least time left for a phase to start (bench.py's)
MULT_MIN_S, MSM_MIN_S, SYNTH_MIN_S = 30, 45, 60


class Line:
    """The bench's JSON line: filled phase by phase by the main thread,
    printed once, by the main thread at the end or by the watchdog at the
    deadline, with only the numbers recorded by then."""

    def __init__(self, deadline_s: float = float("inf")):
        self.t0 = time.perf_counter()
        self.deadline_s = deadline_s
        self._out = {"partial": False}
        self._lock = threading.Lock()        # guards _out
        self._emitted = threading.Lock()     # taken once, never released

    def remaining(self) -> float:
        return self.deadline_s - (time.perf_counter() - self.t0)

    def log(self, msg: str) -> None:
        print(f"[bench +{time.perf_counter() - self.t0:.0f}s] {msg}",
              file=sys.stderr, flush=True)

    def record(self, **items) -> None:
        with self._lock:
            self._out.update(items)

    def get(self, key: str):
        with self._lock:
            return self._out.get(key)

    def snapshot(self) -> dict:
        """The line as recorded so far, with bench.py's value: the warm
        request (its rLC check included) plus the proof phases that ran."""
        with self._lock:
            out = dict(self._out)
        value = None
        if "inference_warm_s" in out:
            value = round(out["inference_warm_s"] + out.get("prove_add_s", 0.0)
                          + out.get("prove_mult_s", 0.0), 3)
        return {"metric": METRIC, "value": value, "unit": "s",
                "vs_baseline": round(BASELINE_S / value, 2) if value else None,
                **out}

    def emit(self, stream, exit_code=None, **final):
        """Record ``final`` and print the line, unless it was printed
        already (then return None).  With ``exit_code`` the process ends
        right after, whatever the main thread is doing.  Returns the line."""
        if not self._emitted.acquire(blocking=False):
            return None
        try:
            self.record(**final)
            out = self.snapshot()
            print(json.dumps(out), file=stream, flush=True)
        finally:
            if exit_code is not None:
                os._exit(exit_code)
        return out

    def skip(self, name: str) -> None:
        self.record(partial=True)
        self.log(f"skipping {name} (deadline)")

    @contextlib.contextmanager
    def phase(self, name: str, device: torch.device):
        """One phase: yields ``seconds()``, the time since the phase began,
        taken after the device has finished.  An exception in the phase is
        recorded as error_<first word of name> and partial, not raised."""
        self.log(name)
        t = time.perf_counter()

        def seconds() -> float:
            synchronize(device)
            return round(time.perf_counter() - t, 3)

        try:
            yield seconds
        except Exception as e:  # noqa: BLE001 -- a failed phase, not the run
            self.record(partial=True, **{
                f"error_{name.split()[0]}": f"{type(e).__name__}: {e}"[:200]})
            self.log(f"{name} FAILED:\n{traceback.format_exc()}")


def exit_code(out: dict) -> int:
    """0 for a whole line, 1 after a failure, 2 when the deadline cut it."""
    if any(k.startswith("error") for k in out):
        return 1
    return 2 if out["partial"] else 0


def device_name(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"."""
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return (f"{torch.cuda.get_device_name(dev)}, power limit not read "
                f"({type(e).__name__})")


def msm_table(dev: torch.device, n: int):
    """bench.py's MSM microbenchmark on ``dev``: n scalars from Random(9)
    against the gens MultiCommitGens.new(n, b"bench_msm"), one untimed MSM
    through the gens' digit table (which builds it), then one timed.
    Returns (scalars, gens, the timed MSM's point, its seconds)."""
    rng = random.Random(9)
    scalars = [rng.randrange(L_MODULUS) for _ in range(n)]
    gens = MultiCommitGens.new(n, b"bench_msm")
    digits = torch.as_tensor(host_digits(scalars), device=dev)
    table = gens.G_msm(dev)
    table.msm(digits)
    synchronize(dev)
    t = time.perf_counter()
    point = table.msm(digits)
    synchronize(dev)
    return scalars, gens, point, time.perf_counter() - t


def run(size: int = 32, device=None, mult_eval: bool = False,
        msm_n: int = MSM_N, synth: int = 0, prove: bool = True,
        line: Line = None) -> dict:
    """Every phase of the bench on ``device`` (the card unless "cpu");
    returns the line.  ``msm_n``: the MSM's points (0 skips it); ``synth``:
    k of the synthetic 2^k stock SNARK (0 skips it); ``line``: the Line to
    fill, which main's watchdog reads too.  Raises only when the device or
    the workload's inputs cannot be set up."""
    line = Line() if line is None else line
    dev = resolve_device(device)
    line.record(device=device_name(dev))

    with line.phase("kernel build", dev) as seconds:
        if dev.type == "cuda":
            kernels.load_all()
        _native.load()
        line.record(kernel_build_s=seconds())

    key = KeyPair.generate(random.Random(0), device=dev)
    img = np.random.RandomState(0).uniform(0.0, 1.0, (size, size)).astype(
        np.float32)

    # the rLC checks stay queued until flush_checks, which rlc_check_s times
    with line.phase("inference cold", dev) as seconds:
        cold = run_conv_workload(img, FILTER, key, random.Random(1),
                                 defer_checks=True)
        line.record(inference_cold_s=seconds())
        cold.flush_checks()
    warm = None
    if line.get("inference_cold_s") is not None:
        with line.phase("inference warm", dev) as seconds:
            res = run_conv_workload(img, FILTER, key, random.Random(2),
                                    defer_checks=True)
            line.record(inference_warm_s=seconds(),
                        num_mults=int(res.trace.num_mults),
                        num_adds=int(res.trace.num_adds))
    if line.get("inference_warm_s") is not None:
        with line.phase("rlc check fetch", dev) as seconds:
            res.flush_checks()
            rlc = seconds()
            line.record(rlc_check_s=rlc, inference_warm_s=round(
                line.get("inference_warm_s") + rlc, 3))
            warm = res

    if prove and warm is not None:
        add, mult = trace_args(warm.trace.finalize())
        with line.phase(f"prove point-add ({len(add[0])} adds)",
                        dev) as seconds:
            st = prove_point_add(*add, tape_seed=TAPE_SEED, quiet=True,
                                 device=dev, full_snark=True)
            line.record(prove_add_s=seconds(), proof_add_bytes=st.size_bytes,
                        verify_add_s=round(st.ver_ms / 1000, 3))
        if line.remaining() > MULT_MIN_S:
            with line.phase(f"prove point-mult ({len(mult[0])} mults)",
                            dev) as seconds:
                st = prove_point_mult(*mult, tape_seed=TAPE_SEED, quiet=True,
                                      device=dev, full_snark=mult_eval)
                line.record(prove_mult_s=seconds(),
                            prove_mult_eval_proof=mult_eval,
                            proof_mult_bytes=st.size_bytes,
                            verify_mult_s=round(st.ver_ms / 1000, 3))
        else:
            line.skip("prove point-mult")

    if msm_n:
        if line.remaining() > MSM_MIN_S:
            with line.phase("msm microbenchmark", dev):
                *_, t = msm_table(dev, msm_n)
                line.record(**{f"msm{msm_n}_table_ms": round(t * 1e3, 4),
                               f"msm{msm_n}_points_per_s": round(msm_n / t)})
        else:
            line.skip("msm microbenchmark")

    if synth > 0:
        if line.remaining() > SYNTH_MIN_S:
            name = f"synthetic_2^{synth}"
            with line.phase(f"synthetic 2^{synth} stock SNARK",
                            dev) as seconds:
                _, ok, nbytes = snark_prove_synthetic(
                    1 << synth, 1 << synth, 10, seed=1, tape_seed=5,
                    device=dev)
                line.record(**{f"{name}_snark_s": seconds(),
                               f"{name}_proof_bytes": int(nbytes),
                               f"{name}_verified": bool(ok)})
                if not ok:
                    raise AssertionError(f"the {name} proof did not verify")
        else:
            line.skip(f"synthetic 2^{synth} stock SNARK")
    return line.snapshot()


def _watchdog(line: Line, stream) -> None:
    while (left := line.remaining()) > 0:
        time.sleep(min(left, 2.0))
    line.log("watchdog: deadline reached, emitting")
    line.emit(stream, exit_code=2, partial=True, watchdog="deadline reached")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vpin_tpu_torch.runner.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("size", type=int, nargs="?", default=32)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    args = p.parse_args(argv)
    env = os.environ.get
    line = Line(float(env("VPIN_BENCH_DEADLINE_S", str(DEADLINE_S))))
    watchdog = threading.Thread(target=_watchdog, args=(line, sys.stdout),
                                daemon=True)
    watchdog.start()
    try:
        run(args.size, args.device,
            mult_eval=env("VPIN_BENCH_MULT_EVAL", "0") == "1",
            msm_n=0 if env("VPIN_BENCH_MSM", "1") == "0" else MSM_N,
            synth=int(env("VPIN_BENCH_SYNTH", "0")),
            prove=env("VPIN_BENCH_PROVE", "1") != "0", line=line)
    except Exception as e:  # noqa: BLE001 -- the line carries the error
        line.record(partial=True, error=f"{type(e).__name__}: {e}"[:300])
        line.log(traceback.format_exc())
    out = line.emit(sys.stdout)
    if out is None:          # the watchdog printed it and ends the process
        watchdog.join()
    return exit_code(out)


if __name__ == "__main__":
    sys.exit(main())
