"""Nested span timer (reference Spartan/src/timer.rs under its `profile`
feature), port of vpin_tpu/utils/timer.py with the same labels.  Prints only
when VPIN_PROFILE is set; a caller that sets RECORD to a list gets every
span appended to it as it stops, with the kernel launches made inside it.
Spans are host time: the device work they enqueue is inside them only up to
the next synchronizing read."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

from .. import kernels

_ENABLED = os.environ.get("VPIN_PROFILE", "0") not in ("0", "", "false")
_DEPTH = 0

#: when a list, each span appends (depth, label, seconds, {kernel: launches})
#: as it stops
RECORD = None


class Timer:
    def __init__(self, label: str):
        global _DEPTH
        self.label = label
        self.t0 = time.perf_counter()
        self.depth = _DEPTH
        self.launches = dict(kernels.LAUNCHES) if RECORD is not None else None
        if _ENABLED:
            print(f"{'*' * (self.depth + 1)} {label}")
        _DEPTH += 1

    def stop(self) -> float:
        global _DEPTH
        _DEPTH -= 1
        dt = time.perf_counter() - self.t0
        if _ENABLED:
            print(f"{'*' * (self.depth + 1)} {self.label} {dt * 1000:.3f}ms")
        if RECORD is not None and self.launches is not None:
            RECORD.append((self.depth, self.label, dt, {
                k: v - self.launches.get(k, 0)
                for k, v in kernels.LAUNCHES.items()}))
        return dt


@contextmanager
def span(label: str):
    t = Timer(label)
    try:
        yield t
    finally:
        t.stop()
