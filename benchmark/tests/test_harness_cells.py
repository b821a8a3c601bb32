"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name from files alone."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import cells, drivers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
ROOT = cells.ROOT


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= bench["run_seconds"] <= 51
    cells_n = 24
    assert ((2 + 14 * cells_n) * (bench["run_seconds"] + 60)
            + cells_n * 180 + 1200) <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    pairs, cell_names = set(), set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell_names.add(w["name"])
    assert {c["config"] for c in bench["workloads"]} == names
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
    metric_names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            assert m["name"] not in metric_names
            metric_names.add(m["name"])
            assert set(m.get("workloads", cell_names)) <= cell_names
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert _line(m["layer"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cell_names))
    for w in cell_names:
        assert len(cells.metrics(bench, w, traced=False)) >= 2
        assert cells.metrics(bench, w, traced=True)
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cell_order_and_names(bench):
    assert [w["name"] for w in bench["workloads"]] == [
        "conv3.prove_add", "cnn_a.serve_32", "conv3.serve_256",
        "conv3.prove_mult"]


@pytest.mark.parametrize("cell", ["conv3.prove_add", "cnn_a.serve_32",
                                  "conv3.serve_256", "conv3.prove_mult"])
def test_pieces_found_by_name(bench, cell):
    c = cells.cell(bench, cell)
    cfg = cells.config(bench, c["config"])
    mix = cells.mix(c["traffic"])
    assert cfg["name"] == c["config"]
    assert drivers.load(mix["driver"]).kind in ("serve", "proof")
    for traced in (False, True):
        for m in cells.metrics(bench, cell, traced):
            assert callable(cells.reader(m["name"]))


def test_a_cell_from_files_alone(bench):
    """A new cell made of an existing configuration and an existing mix
    needs entries, not code: conv3 under serve_32 resolves and runs."""
    from benchmark.tests.small import run_small
    extra = json.loads(json.dumps(bench))
    extra["workloads"].append({"name": "conv3.serve_32", "config": "conv3",
                               "traffic": "serve_32", "chips": 1,
                               "why": "test"})
    for m in extra["end_to_end"]:
        if m["name"] == "request_ms":
            m["workloads"].append("conv3.serve_32")
    cfg = cells.config(extra, "conv3")
    mix = cells.mix("serve_32")
    mix.update(size=4, warm_requests=0, check_points=8, check_requests=1)
    line = run_small(extra, "conv3.serve_32", config=cfg, mix=mix)
    assert line["correct"] and "request_ms" in line["metrics"]


def test_files_under_paths_are_named_from_names():
    for path in Path(cells.HERE).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(cells.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
