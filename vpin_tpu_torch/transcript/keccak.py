"""Keccak-f[1600] permutation (host-side, pure Python).

Copy of vpin_tpu/transcript/keccak.py.  It underlies the STROBE-128 sponge
of the merlin transcript; the transcript is the serial Fiat-Shamir spine
and stays on the host.  Validated against SHA3-256 test vectors.
"""

from __future__ import annotations

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


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _M64


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of a 200-byte state (lane A[x,y] at 8*(x+5y))."""
    A = [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]
    for rnd in range(24):
        # theta
        C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20] for x in range(5)]
        D = [C[(x - 1) % 5] ^ _rol(C[(x + 1) % 5], 1) for x in range(5)]
        A = [A[i] ^ D[i % 5] for i in range(25)]
        # rho + pi
        B = [0] * 25
        for x in range(5):
            for y in range(5):
                B[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(A[x + 5 * y], _ROT[x][y])
        # chi
        A = [B[i] ^ ((~B[(i + 1) % 5 + 5 * (i // 5)]) & _M64
                     & B[(i + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        # iota
        A[0] ^= _RC[rnd]
    for i in range(25):
        state[8 * i: 8 * i + 8] = A[i].to_bytes(8, "little")


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
