"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

Each kernel source compiles with nvcc into its own shared library with a
plain C interface, loaded through ctypes, at first use.  The library's file
name carries a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads from the build directory (``csrc/build/``, listed
in .gitignore).  There is no fallback: a missing nvcc, a failed build or a
failed launch raises.

A source may export several entry points (``ENTRIES``); it is built once
and each entry is bound from its library.  ``LAUNCHES`` counts the kernel
launches of each entry; ``launch`` adds the kernels the call launched (one
unless its caller says otherwise: ``ed_msm`` launches one or two) after a
call that the runtime accepted, and nothing else touches it except a caller
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

#: kernel name -> its source under csrc/
SOURCES = {
    "mont_mul": "mont_mul.cu",
    "e2_add": "e2_add.cu",
    "e2_scalar_mul": "e2_scalar_mul.cu",
    "ed_add": "ed_add.cu",
    "ed_ladder": "ed_ladder.cu",
}

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_WORDS = ctypes.POINTER(ctypes.c_uint32)

#: entry -> (kernel whose source exports it, the C function vpin_<entry>'s
#: argument types before the stream)
ENTRIES = {
    "mont_mul": ("mont_mul", [_P] * 3 + [_I64, _WORDS]),
    "mont_pow": ("mont_mul", [_P] * 2 + [_I64, _WORDS, _WORDS, _I32]),
    "e2_add": ("e2_add", [_P] * 9 + [_I64, _WORDS, _P]),
    "e2_add_wide": ("e2_add", [_P] * 9 + [_I64, _WORDS]),
    "e2_scalar_mul": ("e2_scalar_mul",
                      [_P] * 7 + [_I64, _I32, _I32, _I64, _I64, _WORDS, _I32,
                                  _P]),
    "ed_add": ("ed_add", [_P] * 12 + [_I64, _WORDS]),
    "ed_table": ("ed_add", [_P] * 8 + [_I64, _WORDS]),
    "ed_msm": ("ed_add", [_P] * 4 + [_I64, _P, _I32, _I64] + [_P] * 8
               + [_WORDS]),
    "ed_ladder": ("ed_ladder",
                  [_P] * 9 + [_I64, _I32, _I32, _I64, _I64, _WORDS, _I32,
                              _P]),
}

LAUNCHES = {name: 0 for name in ENTRIES}

_LIBS: dict = {}     # kernel -> its loaded library
_FNS: dict = {}      # entry -> its bound C function


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


def _load(entry: str):
    fn = _FNS.get(entry)
    if fn is None:
        kernel, argtypes = ENTRIES[entry]
        lib = _LIBS.get(kernel)
        if lib is None:
            path = library_path(kernel)
            if not path.exists():
                build([kernel])
            lib = _LIBS[kernel] = ctypes.CDLL(str(path))
        fn = getattr(lib, "vpin_" + entry)
        fn.argtypes = argtypes + [_P]
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return fn


def load_all() -> None:
    """Build every kernel not built yet and bind every entry, so that no
    first launch pays for either."""
    build()
    for entry in ENTRIES:
        _load(entry)


def launch(entry: str, device: torch.device, *args, count: int = 1) -> None:
    """Call entry point ``entry`` on ``device``'s current stream.  ``args``
    are the C function's arguments before the stream; tensors' pointers are
    passed as ints.  ``count``: the kernels this call launches.  Raises if a
    launch was refused."""
    fn = _load(entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
    LAUNCHES[entry] += count


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
