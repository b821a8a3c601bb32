"""What a ``--trace 1`` run records, and how the trace is reduced.

* Spans.  The program's own spans (utils/timer.Timer: gadget,
  witness_commit, SNARK::encode, R1CSProof::prove, R1CSEvalProof::prove,
  verify, ...) are collected through its RECORD hook; a traced run also
  names the serving stages (the pipelines' _Clock stages, encrypt_batch,
  decrypt_batch, the engine's layers) by wrapping them.  While the profiler
  runs, every span is also a profiler annotation, so that the device's idle
  gaps can be split over what the host was doing during them.
* The profiler.  torch.profiler traces the first steps of the window, up to
  the mix's ``trace_seconds``; its kernels give the device's busy time, the
  launches a step, each kernel's time, and the port's kernels' time, which
  the launch log's bounds are divided by.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List

from .work.bounds import LaunchLog, kernel_entry

#: (module of vpin_tpu_torch, attribute, method or None, span label):
#: serving calls a traced run names
SERVING_SPANS = (
    ("nn.models", "encrypt_batch", None, "encrypt_batch"),
    ("nn.models", "decrypt_batch", None, "decrypt_batch"),
    ("nn.homomorphic", "HomomorphicEngine", "conv2d", "conv2d"),
    ("nn.homomorphic", "HomomorphicEngine", "avgpool2d", "avgpool2d"),
    ("nn.homomorphic", "HomomorphicEngine", "fc", "fc"),
    ("nn.homomorphic", "HomomorphicEngine", "flush_checks", "flush_checks"),
)


class Tracer:
    """Installs the spans and the launch log for a traced run; ``profile``
    traces a part of the window; ``reduce`` turns it into numbers."""

    def __init__(self):
        import importlib

        import torch
        self.torch = torch
        self.timer = importlib.import_module("vpin_tpu_torch.utils.timer")
        self.models = importlib.import_module("vpin_tpu_torch.nn.models")
        self.timer.RECORD = []
        self.profiling = False
        self.saved = []
        self.log = LaunchLog().install()
        self._patch_timer()
        self._patch_clock()
        for mod, attr, method, label in SERVING_SPANS:
            m = importlib.import_module("vpin_tpu_torch." + mod)
            owner = getattr(m, attr) if method else m
            name = method or attr
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._named(fn, label))
        self.labels = set()
        self.prof = None
        self.steps_traced = 0
        self.traced_s = 0.0

    # ---------------------------------------------------------- spans
    def annotation(self, label: str):
        if not self.profiling:
            return contextlib.nullcontext()
        self.labels.add(label)
        return self.torch.autograd.profiler.record_function(label)

    def _named(self, fn, label):
        tracer = self

        def wrapper(*args, **kwargs):
            with tracer.annotation(label):
                return fn(*args, **kwargs)
        return wrapper

    def _patch_timer(self):
        Timer, tracer = self.timer.Timer, self
        init, stop = Timer.__init__, Timer.stop

        def new_init(t, label):
            init(t, label)
            t._bench_rf = None
            if tracer.profiling:
                t._bench_rf = tracer.annotation(label)
                t._bench_rf.__enter__()

        def new_stop(t):
            rf = getattr(t, "_bench_rf", None)
            if rf is not None:
                rf.__exit__(None, None, None)
                t._bench_rf = None
            return stop(t)

        Timer.__init__, Timer.stop = new_init, new_stop
        self.saved += [(Timer, "__init__", init), (Timer, "stop", stop)]

    def _patch_clock(self):
        Clock, tracer = self.models._Clock, self
        call = Clock.__call__

        @contextlib.contextmanager
        def new_call(clock, stage):
            with tracer.annotation(stage), call(clock, stage):
                yield

        Clock.__call__ = new_call
        self.saved.append((Clock, "__call__", call))

    def spans(self) -> List[tuple]:
        """(depth, label, seconds) of each program span so far; clears."""
        out = [(d, label, s) for d, label, s, _ in self.timer.RECORD]
        self.timer.RECORD = []
        return out

    def uninstall(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.log.uninstall()
        self.timer.RECORD = None

    # -------------------------------------------------------- profiler
    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.profiling = True
        self.log.active = True
        self.t0 = time.perf_counter()

    def stop(self, steps: int):
        self.torch.cuda.synchronize()
        self.traced_s = time.perf_counter() - self.t0
        self.steps_traced = steps
        self.profiling = False
        self.log.active = False
        self.prof.__exit__(None, None, None)

    def reduce(self) -> Dict:
        """Numbers from the traced part: busy and window seconds, kernel
        launches, each kernel's seconds, the port's kernels' seconds by
        entry, the bounds by entry, and the idle gaps by host span."""
        events, launched = _events(self.prof, self.labels)
        device = sorted((e for e in events if e["cuda"]), key=lambda e: e["t"])
        kernels = [e for e in device
                   if not e["name"].startswith(("Memcpy", "Memset"))]
        spans = [e for e in events if e["annotation"]]
        busy, gaps = _busy_and_gaps(device)
        by_kernel: Dict[str, float] = {}
        port: Dict[str, float] = {}
        for e in kernels:
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
            entry = kernel_entry(e["name"])
            if entry:
                port[entry] = port.get(entry, 0.0) + e["dur"]
        # the launch calls' lead on their operations: how far the two
        # clocks of the trace can be read as one
        lags = sorted(device[i]["t"] - launched[device[i]["corr"]]
                      for i in range(len(device))
                      if device[i]["corr"] in launched)
        named = [(start, length) for start, length, _ in gaps]
        idle = _name_gaps(named, spans)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": busy, "window_s": self.traced_s,
            "steps": self.steps_traced, "kernels": len(kernels),
            "port_s": port, "bound_s": self.log.bounds(),
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda kv: -kv[1])[:10],
            "launch_lag_s": lags[len(lags) // 2] if lags else None,
        }


def _events(prof, labels):
    """The trace's device operations and the host spans named ``labels``,
    as dicts (name, start and duration in seconds, whether it ran on the
    device, whether it is a span, the launch's correlation id), and the
    host time of each launch call by correlation id."""
    from torch.autograd import DeviceType
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler kept no kineto results: no device "
                           "trace to read")
    out, launched = [], {}
    for e in results.events():
        name = e.name()
        cuda = e.device_type() == DeviceType.CUDA
        t = e.start_ns() * 1e-9
        # a span shows on the device's side too (gpu_user_annotation):
        # only the host's copy is kept
        if name in labels and not cuda:
            out.append({"name": name, "t": t, "cuda": False,
                        "dur": e.duration_ns() * 1e-9,
                        "annotation": True, "corr": None})
        elif cuda and name not in labels:
            out.append({"name": name, "t": t, "cuda": True,
                        "dur": e.duration_ns() * 1e-9,
                        "annotation": False, "corr": _corr(e)})
        elif not cuda and name.startswith("cu") and _corr(e):
            launched[_corr(e)] = t
    return out, launched


def _corr(e):
    """A trace event's correlation id, which ties a launch call on the
    host to the operation it put on the device."""
    get = getattr(e, "correlation_id", None)
    return get() if callable(get) else None


def _busy_and_gaps(device: List[Dict]):
    """The union of the device's operations (sorted by start) in seconds,
    and the gaps between them as (start, length, index of the operation
    that ends the gap)."""
    busy, gaps, end = 0.0, [], None
    for i, e in enumerate(device):
        s, t = e["t"], e["t"] + e["dur"]
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s - end, i))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy, gaps


def _innermost(spans) -> List[tuple]:
    """(start, end, name) segments of the host's time, each named by the
    innermost span open in it (spans nest)."""
    marks = sorted([(e["t"], 1, i) for i, e in enumerate(spans)]
                   + [(e["t"] + e["dur"], -1, i) for i, e in enumerate(spans)],
                   key=lambda m: (m[0], m[1]))
    out, stack, last = [], [], None
    for t, kind, i in marks:
        if stack and last is not None and t > last:
            out.append((last, t, spans[stack[-1]]["name"]))
        if kind == 1:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        last = t
    return out


def _name_gaps(gaps, spans) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each (start, length) gap
    is split over the innermost host spans open during it."""
    segs = _innermost(spans)
    starts = [s for s, _, _ in segs]
    out: Dict[str, float] = {}
    for g0, length in gaps:
        g1, left = g0 + length, length
        k = max(0, bisect.bisect_right(starts, g0) - 1)
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, name = segs[k]
            part = min(s1, g1) - max(s0, g0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part
                left -= part
            k += 1
        if left > 1e-12:
            out["(outside any span)"] = out.get("(outside any span)", 0.0) + left
    return out


def spans_by_label(spans: List[tuple]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for _, label, s in spans:
        out[label] = out.get(label, 0.0) + s
    return out
