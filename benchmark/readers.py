"""What the metric readers share: each file under benchmark/metrics/ is a
``read(rec)`` that returns a number, or None where the run has nothing for
it to read (the harness then leaves the metric out of the line).

``rec`` is the run's record:
  kind        "serve" or "proof", the driver's
  setup_s     process start to the first timed step
  window_s    the window's start to the end of its last whole step
  steps       one dict a step that ended: ok, latency_s, profiled (the
              profiler traced it), and what the driver and the tracer
              added (timings, spans by label; in a traced run, work: the
              32-bit multiplies the step needs, work/counts.py)
  peak_window_bytes  the card's allocation peak in the window
  trace       Tracer.reduce()'s numbers, in a traced run
"""

from __future__ import annotations

from math import ceil
from statistics import fmean
from typing import Dict, Optional

from .work.peaks import MUL32_PER_S


def ok_steps(rec: Dict):
    return [s for s in rec["steps"] if s.get("ok")]


def per_step_ms(rec: Dict, kind: str, *keys, source: str) -> Optional[float]:
    """Mean over the steps of the summed ``keys`` of each step's
    ``source`` dict (timings or spans), in ms: over the steps the profiler
    did not trace where there are any, since it slows the host."""
    if rec["kind"] != kind:
        return None
    steps = ok_steps(rec)
    quiet = [s for s in steps if not s.get("profiled")]
    vals = []
    for s in quiet or steps:
        d = s.get(source) or {}
        if not any(k in d for k in keys):
            return None
        vals.append(sum(d.get(k, 0.0) for k in keys))
    return fmean(vals) * 1e3 if vals else None


def window_rate_ms(rec: Dict, kind: str) -> Optional[float]:
    n = len(rec["steps"])
    if rec["kind"] != kind or not n:
        return None
    return rec["window_s"] / n * 1e3


def percentile_ms(rec: Dict, kind: str, q: float) -> Optional[float]:
    """The nearest-rank q-th percentile of every step's latency."""
    lat = sorted(s["latency_s"] for s in rec["steps"])
    if rec["kind"] != kind or not lat:
        return None
    return lat[max(0, ceil(q / 100 * len(lat)) - 1)] * 1e3


def traced(rec: Dict, kind: str) -> Optional[Dict]:
    t = rec.get("trace")
    if rec["kind"] != kind or not t or not t["steps"]:
        return None
    return t


def launches(rec: Dict, kind: str) -> Optional[float]:
    t = traced(rec, kind)
    return t["kernels"] / t["steps"] if t and t["kernels"] else None


def idle_pct(rec: Dict, kind: str) -> Optional[float]:
    t = traced(rec, kind)
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(rec: Dict, kind: str) -> Optional[float]:
    """The port's kernels' summed bound over their summed device time;
    None where none ran."""
    t = traced(rec, kind)
    if not t:
        return None
    spent = sum(t["port_s"].values())
    bound = sum(t["bound_s"].get(n, 0.0) for n in t["port_s"])
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def mfu_pct(rec: Dict, kind: str) -> Optional[float]:
    """The protocol's 32-bit multiplies over the steps' time at the card's
    peak multiply rate (over the steps the profiler did not trace, where
    there are any)."""
    if rec["kind"] != kind:
        return None
    steps = [s for s in ok_steps(rec) if "work" in s]
    steps = [s for s in steps if not s.get("profiled")] or steps
    spent = sum(s["latency_s"] for s in steps)
    if not steps or spent <= 0:
        return None
    return 100.0 * sum(s["work"] for s in steps) / (MUL32_PER_S * spent)
