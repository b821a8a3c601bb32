"""Client/server socket transport, the reference's wire protocol byte for byte.

Port of vpin_tpu/nn/transport.py (reference src/cnn_networks/Server.py:95-149,
Client.py:85-123): pickled objects over TCP on 127.0.0.1, the length first as
decimal text, then 30,000-byte chunks, each answered by a text ACK.

A ciphertext travels as vpin_tpu's payload, ``{"c1": [x, y, z], "c2": [x, y,
z]}`` of numpy (..., 16) uint32 arrays of 16-bit limbs (Montgomery residues
for R = 2^256), so that a vpin_tpu client can talk to this package's server
and the reverse.  The port's (..., 8) 32-bit limbs repack to and from that
layout in numpy.
"""

from __future__ import annotations

import pickle
import socket
import time
from typing import Any

from ..convert import limbs16_to_32, limbs32_to_16
from ..curve.weierstrass import PointW
from ..device import resolve_device
from ..field.limbs import to_numpy, to_tensor
from .elgamal import CipherTensor

FORMAT = "utf-8"
SIZE = 256_000
CHUNK = 30_000
HOST = "127.0.0.1"


def send_in_chunks(sock: socket.socket, data: bytes) -> None:
    sock.sendall(str(len(data)).encode(FORMAT))
    sock.recv(SIZE)
    for i in range(0, len(data), CHUNK):
        sock.sendall(data[i:i + CHUNK])
        sock.recv(SIZE)


def recv_in_chunks(sock: socket.socket) -> bytes:
    total = int(sock.recv(SIZE).decode(FORMAT))
    sock.send(b"length received")
    parts = []
    received = 0
    for i in range((total + CHUNK - 1) // CHUNK):
        want = min(CHUNK, total - received)
        buf = b""
        while len(buf) < want:
            part = sock.recv(want - len(buf))
            if not part:
                raise ConnectionError("peer closed mid-chunk")
            buf += part
        parts.append(buf)
        received += len(buf)
        sock.send(f"chunk {i} received".encode(FORMAT))
    return b"".join(parts)


def send_obj(sock: socket.socket, obj: Any) -> None:
    send_in_chunks(sock, pickle.dumps(obj))


def recv_obj(sock: socket.socket) -> Any:
    return pickle.loads(recv_in_chunks(sock))


def ciphertensor_to_payload(ct: CipherTensor) -> dict:
    """The port's ciphertexts -> vpin_tpu's payload of (..., 16) limbs."""
    return {"c1": [limbs32_to_16(to_numpy(c)) for c in ct.c1],
            "c2": [limbs32_to_16(to_numpy(c)) for c in ct.c2]}


def payload_to_ciphertensor(payload: dict, device=None) -> CipherTensor:
    """vpin_tpu's payload -> the port's ciphertexts on ``device``."""
    dev = resolve_device(device)
    return CipherTensor(*(PointW(*(to_tensor(limbs16_to_32(a), dev)
                                   for a in payload[half]))
                          for half in ("c1", "c2")))


def send_ciphertensor(sock: socket.socket, ct: CipherTensor) -> None:
    send_obj(sock, ciphertensor_to_payload(ct))


def recv_ciphertensor(sock: socket.socket, device=None) -> CipherTensor:
    return payload_to_ciphertensor(recv_obj(sock), device)


def serve(port: int):
    """Bind 127.0.0.1:port, listen, accept one client -> (server, conn)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((HOST, port))
    srv.listen()
    conn, _ = srv.accept()
    return srv, conn


def connect(port: int, wait_s: float = 60.0) -> socket.socket:
    """Connect to 127.0.0.1:port, retrying while no server listens yet."""
    deadline = time.monotonic() + wait_s
    while True:
        cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            cli.connect((HOST, port))
            return cli
        except ConnectionRefusedError:
            cli.close()
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
