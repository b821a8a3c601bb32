"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, loaded through ctypes, at first use.  The library's file
name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads from the build directory (``csrc/build/``, listed
in .gitignore).  There is no fallback: a missing nvcc, a failed build or a
failed launch raises.

``LAUNCHES`` counts the launches of each kernel; ``launch`` adds one after a
launch that the runtime accepted, and nothing else touches it except a caller
that resets it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> its source under csrc/; the C entry point is vpin_<name>
SOURCES = {
    "mont_mul": "mont_mul.cu",
    "e2_add": "e2_add.cu",
    "e2_scalar_mul": "e2_scalar_mul.cu",
    "ed_add": "ed_add.cu",
    "ed_ladder": "ed_ladder.cu",
}

LAUNCHES = {name: 0 for name in SOURCES}

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: all) that are not built yet, one
    nvcc process each, all started together.  Returns {name: compiler log};
    the log holds ptxas's register and spill report.  Raises on a failed
    build."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            logs[name] = log.read_text() if log.exists() else ""
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        log.write_text(text)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def _load(name: str):
    fn = _LOADED.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        fn = getattr(ctypes.CDLL(str(path)), "vpin_" + name)
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        consts = ctypes.POINTER(ctypes.c_uint32)
        fn.argtypes = {
            "mont_mul": [p] * 3 + [i64, consts, p],
            "e2_add": [p] * 9 + [i64, consts, p],
            "e2_scalar_mul": [p] * 7 + [i64, i32, i32, i64, i64, consts, p],
            "ed_add": [p] * 12 + [i64, consts, p],
            "ed_ladder": [p] * 9 + [i64, i32, i32, i64, i64, consts, p],
        }[name]
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on ``device``'s current stream.  ``args`` are
    the C entry point's arguments before the stream; tensors' pointers are
    passed as ints.  Raises if the launch was refused."""
    fn = _load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def check_limbs(name: str, *tensors) -> torch.device:
    """Validate limb tensors for a kernel wrapper: int32, last dim 8, one
    device, CPU or CUDA.  Returns the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: limbs must be int32, got {t.dtype}")
        if t.dim() < 1 or t.shape[-1] != 8:
            raise ValueError(f"{name}: limbs must have a last dim of 8, "
                             f"got shape {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def kernel_operand(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` broadcast to ``shape`` as a dense row-major tensor the kernel
    can read with 16-byte loads."""
    t = t.expand(shape).contiguous()
    if t.data_ptr() % 16:
        raise ValueError("limb tensor is not 16-byte aligned")
    return t


def consts_array(words) -> ctypes.Array:
    """Host uint32 words as a ctypes array for a kernel's constants."""
    words = [int(w) for w in words]
    return (ctypes.c_uint32 * len(words))(*words)
