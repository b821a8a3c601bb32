"""Keccak-f[1600] permutation (host-side, pure Python).

The permutation of vpin_tpu/transcript/keccak.py.  It underlies the
STROBE-128 sponge of the merlin transcript; the transcript is the serial
Fiat-Shamir spine and stays on the host.  The sponge runs on the C core
(csrc/keccak.c); this is its plain version, which Strobe128(..., native=
False) selects: the rounds run as one generated straight-line Python
function over 25 local lanes (no per-lane calls or index arithmetic),
several times the speed of the looped form.  Validated against SHA3-256
test vectors.
"""

from __future__ import annotations

import struct

_M64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rol_src(v: str, n: int) -> str:
    n %= 64
    return v if n == 0 else f"((({v}) << {n}) | (({v}) >> {64 - n})) & M"


def _permutation_source() -> str:
    """Python source of the 24 rounds over 25 local lanes a0..a24 (lane
    A[x,y] is a{x+5y}), each step written out: the theta, rho, pi, chi and
    iota of keccak_f1600 without a loop or a call inside a round."""
    a = [f"a{i}" for i in range(25)]
    body = ["def _rounds(A, RC, M):",
            f"    {', '.join(a)} = A",
            "    for rc in RC:"]
    for x in range(5):
        col = " ^ ".join(a[x + 5 * y] for y in range(5))
        body.append(f"        c{x} = {col}")
    for x in range(5):
        body.append(f"        d{x} = c{(x - 1) % 5} ^ "
                    f"{_rol_src(f'c{(x + 1) % 5}', 1)}")
    for x in range(5):
        for y in range(5):
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            body.append(f"        b{dst} = "
                        f"{_rol_src(f'{a[x + 5 * y]} ^ d{x}', _ROT[x][y])}")
    for i in range(25):
        j = (i + 1) % 5 + 5 * (i // 5)
        k = (i + 2) % 5 + 5 * (i // 5)
        body.append(f"        a{i} = b{i} ^ (~b{j} & b{k})")
    body.append("        a0 ^= rc")
    body.append(f"    return ({', '.join(a)})")
    return "\n".join(body) + "\n"


_NS: dict = {}
exec(compile(_permutation_source(), "<keccak rounds>", "exec"), _NS)
_rounds = _NS["_rounds"]
_LANES = struct.Struct("<25Q")


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of a 200-byte state (lane A[x,y] at 8*(x+5y))."""
    state[:] = _LANES.pack(*_rounds(_LANES.unpack(state), _RC, _M64))


def sha3_256(data: bytes) -> bytes:
    """Minimal SHA3-256 built on keccak_f1600 (validation only)."""
    rate = 136
    state = bytearray(200)
    padded = bytearray(data)
    padded.append(0x06)
    while len(padded) % rate != 0:
        padded.append(0)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            state[i] ^= padded[off + i]
        keccak_f1600(state)
    return bytes(state[:32])
