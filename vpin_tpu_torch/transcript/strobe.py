"""STROBE-128 (the merlin subset): AD / meta-AD / PRF / KEY over
Keccak-f[1600], bit-compatible with merlin's strobe.rs.

Port of vpin_tpu/transcript/strobe.py.  The inner byte loops and the
permutation run in the C core (csrc/keccak.c, built and loaded by
_native.py); ``native=False`` selects the plain Python version instead
(keccak.py, and loops here that absorb a run of bytes up to the rate's end
as one integer).  Both give the same bytes.
"""

from __future__ import annotations

import ctypes

from . import _native
from .keccak import keccak_f1600

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5

_R = 166  # STROBE-128 rate over keccak-f[1600] (168 minus 2 reserved bytes)


class Strobe128:
    """STROBE-128 over a 200-byte state; ``native`` picks the C core (the
    default) or the plain Python version."""

    def __init__(self, protocol_label: bytes, native: bool = True):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        self.state = st
        self._lib = _native.load() if native else None
        if self._lib is not None:
            # the C core works on the state in place, through this view
            self._posbuf = (ctypes.c_int32 * 2)()
            self._stview = (ctypes.c_ubyte * 200).from_buffer(st)
            self._lib.keccak_f1600(self._stview)
        else:
            keccak_f1600(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- the C core ------------------------------------------------------

    def _native(self, fn, *args) -> None:
        """One call of the C core with pos and pos_begin passed through."""
        self._posbuf[0] = self.pos
        self._posbuf[1] = self.pos_begin
        fn(self._stview, self._posbuf, *args)
        self.pos = self._posbuf[0]
        self.pos_begin = self._posbuf[1]

    # -- internals -----------------------------------------------------

    def _run_f(self) -> None:
        if self._lib is not None:
            self._native(self._lib.strobe_run_f)
            return
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        if self._lib is not None:
            data = bytes(data)
            self._native(self._lib.strobe_absorb, data, len(data))
            return
        # XOR as much as fits before the next permutation at once, as one
        # integer (byte for byte the same as a loop over the bytes)
        i, n = 0, len(data)
        while i < n:
            k = min(n - i, _R - self.pos)
            lo, hi = self.pos, self.pos + k
            run = (int.from_bytes(self.state[lo:hi], "little")
                   ^ int.from_bytes(data[i:i + k], "little"))
            self.state[lo:hi] = run.to_bytes(k, "little")
            self.pos = hi
            i += k
            if self.pos == _R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        if self._lib is not None:
            data = bytes(data)
            self._native(self._lib.strobe_overwrite, data, len(data))
            return
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        if self._lib is not None:
            out = (ctypes.c_ubyte * n)()
            self._native(self._lib.strobe_squeeze, out, n)
            return bytes(out)
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("cannot continue with different flags")
            return
        if flags & FLAG_T:
            raise ValueError("transport not implemented")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = (flags & (FLAG_C | FLAG_K)) != 0
        if force_f and self.pos != 0:
            self._run_f()

    # -- checkpoint support ---------------------------------------------

    def snapshot(self) -> tuple:
        """The sponge state as host bytes and ints (the same tuple as
        vpin_tpu's), for intra-proof checkpoints."""
        return (bytes(self.state), self.pos, self.pos_begin, self.cur_flags)

    def restore(self, snap: tuple) -> None:
        state, pos, pos_begin, cur_flags = snap
        if len(state) != 200:
            raise ValueError("a STROBE state is 200 bytes")
        # in place: the C core's view aliases this buffer
        self.state[:] = state
        self.pos = pos
        self.pos_begin = pos_begin
        self.cur_flags = cur_flags

    # -- public ops (merlin subset) -------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)
