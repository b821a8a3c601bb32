"""Nothing the benchmark runs loads JAX or vpin_tpu; the reference loads
none of JAX, vpin_tpu or vpin_tpu_torch.  Top-level names are compared
whole: vpin_tpu_torch begins with vpin_tpu and is allowed."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import cells
from benchmark.run import FORBIDDEN, forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules({"vpin_tpu_torch", "vpin_tpu_torch.nn",
                              "numpy", "jaxtyping"}) == []
    assert forbidden_modules({"vpin_tpu.nn.models"}) == ["vpin_tpu"]
    assert forbidden_modules({"jaxlib.xla_client", "jax"}) == ["jax", "jaxlib"]
    assert forbidden_modules({"flax.linen"}) == ["flax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for path in (cells.HERE / "reference").glob("*.py"):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "vpin_tpu",
                            "vpin_tpu_torch"}, (path, names)


def test_harness_sources_import_no_jax():
    for path in cells.HERE.rglob("*.py"):
        assert not set(_imports(path)) & set(FORBIDDEN), path


def test_a_run_loads_no_jax():
    """A small run of a cell in a fresh process leaves no forbidden module
    in sys.modules."""
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        ""
        "from benchmark.tests.small import run_small\n"
        "from benchmark import cells\n"
        "from benchmark.run import forbidden_modules\n"
        "line = run_small(cells.benchmark(), 'conv3.serve_256')\n"
        "assert line['correct'], line\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FORBIDDEN []" in r.stdout
