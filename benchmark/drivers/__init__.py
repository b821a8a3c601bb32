"""How a cell's steps are driven.  A traffic mix names its driver
(``"driver"`` in benchmark/traffic/<mix>.json); each driver is one module
here with a class ``Driver``, found by that name.

A driver gets the run's context and offers:
  setup()        make the cell's inputs from the seed, warm every shape
  step(i)        one closed-loop step (a request or a proof); raises on a
                 failure the program reports
  release()      let go of the program's state once the window has closed
  checks()       the numbers compared with the reference, each with its
                 limit: {name: (value, limit)}
  work(i)        the 32-bit multiplies step i needs (work/counts.py)
and sets ``kind`` ("serve" or "proof"), which the metrics read.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}").Driver
