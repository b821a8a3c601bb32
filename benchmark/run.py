"""The benchmark of vpin_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds vpin_tpu_torch.  A run builds or
loads the kernels (vpin_tpu_torch/csrc/build, inside the checkout), makes
the cell's inputs from the seed, warms the cell's shapes, runs its steps in
a closed loop for ``--seconds`` (every step started in the window runs to
its end), then compares what the window produced with the plain reference
under benchmark/reference/ and prints one JSON line on stdout: correct,
attempted, failed, metrics (the cell's end-to-end metrics; with --trace 1
its per-layer ones), device, with --trace 1 breakdown, and last the checks,
each number compared beside its limit.  The same checks end stderr.

Exit codes: 0 with the line printed; 1 when the run could not be set up
(no line); 2 without CUDA or with fewer cards than the cell asks for (no
line); 3 when a module of JAX or of vpin_tpu was loaded (no line).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, Optional  # noqa: E402

from . import cells, drivers  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vpin_tpu")

#: PyTorch's host threads, pinned: its default on a one-card machine (8
#: cores), so that the host's share of the work does not follow the shape
#: of the machine a run lands on
HOST_THREADS = 8


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (sys.modules),
    compared whole: vpin_tpu_torch is not vpin_tpu."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - T_START:.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(bench: Dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: Optional[Dict] = None,
             mix: Optional[Dict] = None, t_start: float = None,
             control: bool = False) -> Dict:
    """One run of cell ``name``; returns the result line as a dict.
    ``config`` and ``mix`` replace the cell's files (the tests' small
    sizes); ``device`` "cpu" runs the port's plain versions (tests only);
    ``control`` runs the cell's control (benchmark/control.py)."""
    import torch

    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.transcript import _native

    from .tracing import Tracer, spans_by_label

    t_start = T_START if t_start is None else t_start
    cell = cells.cell(bench, name)
    cfg = config if config is not None else cells.config(bench, cell["config"])
    mx = mix if mix is not None else cells.mix(cell["traffic"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    setup_parts = {"imports_s": time.perf_counter() - t_start}
    if on_card:
        kernels.load_all()
    _native.load()
    setup_parts["kernels_s"] = time.perf_counter() - t_start
    ctx = cells.Context(cell, cfg, mx, seed, dev, trace, control)
    drv = drivers.load(mx["driver"])(ctx)
    tracer = Tracer() if trace else None
    try:
        log(f"set-up of {name}, seed {seed}")
        drv.setup()
        _sync(dev)
        if tracer:
            tracer.spans()
        # what set-up made lives through the window: the collector's full
        # passes in the window then walk only what the steps make
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        peak_setup = torch.cuda.max_memory_allocated(dev) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)

        log(f"window of {seconds} s")
        steps, errors = [], []
        trace_s = float(mx.get("trace_seconds", seconds))
        profiling = bool(tracer) and on_card
        if profiling:
            tracer.start()
        paused = 0.0
        w0 = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            info, ok = {}, True
            try:
                with (tracer.annotation("step") if tracer
                      else contextlib.nullcontext()):
                    info = drv.step(i) or {}
            except Exception as e:  # noqa: BLE001 -- a failed step
                ok = False
                errors.append(f"step {i}: {type(e).__name__}: {e}"[:400])
                log(errors[-1])
                _sync(dev)
            now = time.perf_counter()
            step = {"ok": ok, "latency_s": now - t, "profiled": profiling,
                    **info}
            if tracer:
                step["spans"] = spans_by_label(tracer.spans())
            steps.append(step)
            i += 1
            if profiling and now - w0 - paused >= trace_s:
                p = time.perf_counter()
                tracer.stop(i)
                profiling = False
                paused += time.perf_counter() - p
            if now - w0 - paused >= seconds:
                break
        if profiling:
            tracer.stop(i)
        window_s = time.perf_counter() - w0 - paused
        _sync(dev)
        peak_window = torch.cuda.max_memory_allocated(dev) if on_card else 0
        log(f"window closed: {len(steps)} steps in {window_s:.3f} s")

        rec = {"kind": drv.kind, "setup_s": setup_s, "window_s": window_s,
               "steps": steps, "peak_window_bytes": peak_window,
               "trace": None}
        if tracer:
            if on_card and tracer.prof is not None:
                rec["trace"] = tracer.reduce()
            for j, s in enumerate(steps):
                if s["ok"]:
                    s["work"] = drv.work(j)
    finally:
        gc.unfreeze()
        if tracer:
            tracer.uninstall()
        drv.release()

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = drv.checks()
    checks["failed"] = (sum(not s["ok"] for s in steps),
                        mx["limits"].get("failed", 0))
    log(f"checks made in {time.perf_counter() - t:.1f} s")

    metrics = {}
    for m in cells.metrics(bench, name, traced=trace):
        v = cells.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(max(peak_setup, peak_window))}
    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": len(steps),
            "failed": sum(not s["ok"] for s in steps),
            "metrics": metrics, "device": device_info}
    if rec["trace"]:
        device_info["busy_s"] = rec["trace"]["busy_s"]
        device_info["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                             "idle_gaps": rec["trace"]["idle_gaps"]}
        line["launch_lag_s"] = rec["trace"]["launch_lag_s"]
    if on_card:
        line["card"] = card_name()
    line["setup"] = setup_parts
    line["latencies_ms"] = [round(s["latency_s"] * 1e3, 3) for s in steps]
    if errors:
        line["errors"] = errors[:5]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"power limit not read ({type(e).__name__})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = cells.benchmark()
        cell = cells.cell(bench, args.workload)
        import torch
    except Exception:  # noqa: BLE001 -- no line without a benchmark
        traceback.print_exc()
        return 1
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    try:
        line = run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace))
    except Exception:  # noqa: BLE001 -- no line for a run that broke
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
