"""The contract's result line, for --trace 0 and --trace 1, and what a run
does without a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import cells, run
from benchmark.tests.small import run_small

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("trace", [False, True])
def test_line_shape(bench, trace):
    cell = "conv3.serve_256"
    line = run_small(bench, cell, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert DEVICE_KEYS <= set(line["device"])
    allowed = {m["name"] for m in cells.metrics(bench, cell, traced=trace)}
    assert set(line["metrics"]) <= allowed
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"encrypt_ms", "server_ms"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"request_ms", "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_no_line_without_a_card(capsys):
    """On a machine without CUDA the run exits non-zero and prints no
    result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "conv3.prove_add", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert "{" not in capsys.readouterr().out


def test_no_line_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "conv3.prove_add", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout


@pytest.mark.card
def test_each_cell_on_the_card(bench, card):
    """A short run of each cell on the card is correct and reports its
    end-to-end metrics."""
    for w in bench["workloads"]:
        line = run.run_cell(bench, w["name"], 2 ** 31 + 11, 3, False)
        assert line["correct"], (w["name"], line["checks"])
        want = {m["name"] for m in cells.metrics(bench, w["name"], False)}
        assert set(line["metrics"]) == want
