"""Build and load the transcript's C core (csrc/keccak.c) through ctypes.

Port of vpin_tpu/transcript/_native.py.  At first use gcc -O3 builds the
source into a shared library in csrc/build/ (listed in .gitignore), named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads from there.  A missing gcc or a failed build raises:
there is no silent fallback.  The plain Python version (keccak.py and
Strobe128's own loops) runs only when a caller asks for it
(``Strobe128(label, native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "keccak.c"
BUILD_DIR = CSRC / "build"
CFLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None


def library_path() -> Path:
    """Where the library lives once built."""
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"keccak-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the core unless it is built already; returns the library's
    path.  Raises on a missing gcc or a failed build."""
    out = library_path()
    if out.exists():
        return out
    gcc = shutil.which("gcc")
    if gcc is None:
        raise RuntimeError("gcc not found: the transcript's C core "
                           f"({SOURCE}) needs a C compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gcc, *CFLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed (gcc exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    return out


def load() -> ctypes.CDLL:
    """The core's library, built and bound at the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.keccak_f1600.argtypes = [u8p]
        for name in ("strobe_absorb", "strobe_overwrite"):
            getattr(lib, name).argtypes = [u8p, i32p, ctypes.c_char_p,
                                           ctypes.c_int64]
        lib.strobe_squeeze.argtypes = [u8p, i32p, u8p, ctypes.c_int64]
        lib.strobe_run_f.argtypes = [u8p, i32p]
        for fn in (lib.keccak_f1600, lib.strobe_absorb, lib.strobe_overwrite,
                   lib.strobe_squeeze, lib.strobe_run_f):
            fn.restype = None
        _LIB = lib
    return _LIB
