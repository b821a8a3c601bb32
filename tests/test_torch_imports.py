"""The port stands alone: no file of vpin_tpu_torch, nor chip_smoke.py, nor
the port's measuring scripts (scripts/torch_*.py), imports JAX or anything
of vpin_tpu (checked on the source, by AST, and at run time in a fresh
interpreter)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = (sorted((ROOT / "vpin_tpu_torch").rglob("*.py"))
         + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "vpin_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_vpin_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "vpin_tpu_torch/curve/cuda_ec.py" in names
    assert "vpin_tpu_torch/nn/homomorphic.py" in names
    assert "vpin_tpu_torch/snark/cp_snark.py" in names
    assert "vpin_tpu_torch/spark/sparse_mlpoly.py" in names
    assert "vpin_tpu_torch/spark/product_tree.py" in names
    assert "vpin_tpu_torch/spark/__init__.py" in names
    for mod in ("nn/bsgs.py", "nn/models.py", "nn/accuracy.py", "convert.py",
                "runner/cli.py"):
        assert f"vpin_tpu_torch/{mod}" in names
    tree = ast.parse("import jax.numpy as jnp\nfrom vpin_tpu.field import FQ\n"
                     "from .field import FQ\n")
    assert list(_imported_modules(tree)) == ["jax.numpy", "vpin_tpu.field"]


def test_the_walk_sees_the_measuring_scripts():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for script in ("torch_lenet_layer_proofs.py", "torch_layer_memory.py",
                   "torch_profile_proof.py", "torch_synthetic_profiler.py"):
        assert f"scripts/{script}" in names
    assert "scripts/lenet_layer_proofs.py" not in names     # vpin_tpu's


def test_no_jax_or_vpin_tpu_at_run_time():
    """Importing the CNN slice's modules (and the CLI) loads neither JAX nor
    vpin_tpu."""
    code = (
        "import sys\n"
        "import vpin_tpu_torch.nn.bsgs, vpin_tpu_torch.nn.models\n"
        "import vpin_tpu_torch.nn.accuracy, vpin_tpu_torch.convert\n"
        "import vpin_tpu_torch.runner.cli\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vpin_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_walk_sees_the_sharded_prover_and_the_c_core():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("parallel/__init__.py", "parallel/mesh.py", "parallel/ops.py",
                "parallel/dryrun.py", "transcript/_native.py"):
        assert f"vpin_tpu_torch/{mod}" in names


def test_sharded_prover_loads_no_jax_at_run_time():
    """The mesh, its entries and the dryrun, with the transcript's C core
    built and used, load neither JAX nor vpin_tpu."""
    code = (
        "import sys\n"
        "import vpin_tpu_torch.parallel.dryrun\n"
        "from vpin_tpu_torch.transcript import Transcript\n"
        "assert Transcript(b't').strobe._lib is not None\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vpin_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
