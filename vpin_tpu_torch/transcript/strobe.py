"""STROBE-128 (the merlin subset): AD / meta-AD / PRF / KEY over
Keccak-f[1600], bit-compatible with merlin's strobe.rs.

Port of vpin_tpu/transcript/strobe.py in pure Python (the reference's
optional C core is not used); absorb XORs a run of bytes up to the rate's
end as one integer.
"""

from __future__ import annotations

from .keccak import keccak_f1600

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5

_R = 166  # STROBE-128 rate over keccak-f[1600] (168 minus 2 reserved bytes)


class Strobe128:
    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals -----------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
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
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
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
        self.state = bytearray(state)
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
