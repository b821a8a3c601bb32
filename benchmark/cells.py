"""Finding a cell's pieces by name: its entry in BENCHMARK.json, its
configuration's file, its traffic mix (benchmark/traffic/<mix>.json), and
each metric's reader (benchmark/metrics/<metric>.py)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell named {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def mix(name: str) -> Dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _applies(metric: Dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics(bench: Dict, cell_name: str, traced: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with a trace its per-layer ones."""
    return [m for m in bench["per_layer" if traced else "end_to_end"]
            if _applies(m, cell_name)]


_READERS: Dict[str, Callable] = {}


def reader(name: str) -> Callable:
    """``read(rec)`` of benchmark/metrics/<name>.py."""
    if name not in _READERS:
        path = HERE / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark.metrics.{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _READERS[name] = mod.read
    return _READERS[name]


@dataclass
class Context:
    """What a driver is handed."""
    cell: Dict
    config: Dict
    mix: Dict
    seed: int
    device: object
    trace: bool
    #: run the cell's control (benchmark/control.py)
    control: bool = False
