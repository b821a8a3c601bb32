"""The conv workload split over two processes by the socket transport.

Port of vpin_tpu/nn/socket_runner.py (reference src/cnn_networks/Server.py
:95-149 for the server, Client.py:85-123 for the client, script.sh:49-108):
the client makes its key, sends the public parameters, encrypts the image
and sends it; the server runs the homomorphic conv with the rLC checks and
the witness trace and returns the counts and the output ciphertext.  Both
ends speak the reference's protocol (nn/transport.py), so either end may be
vpin_tpu's.  The server computes on its device, the client encrypts on its
own; both default to the GPU.

    python -m vpin_tpu_torch.runner.cli serve-conv --port P
    python -m vpin_tpu_torch.runner.cli client-conv --port P --size 32
"""

from __future__ import annotations

import random
from typing import Callable, Optional

import numpy as np

from ..device import resolve_device
from ..utils.timer import span
from . import fixed_point
from .elgamal import CipherTensor, KeyPair, encrypt_batch
from .homomorphic import HomomorphicEngine
from .models import CONV_FILTERS
from .prf import fresh_key
from .transport import (
    connect, recv_ciphertensor, recv_obj, send_ciphertensor, send_obj, serve,
)

WELCOME = "Welcome to the server!"


def server_main(port: int, filter_size: int = 3,
                export_dir: Optional[str] = None, device=None,
                key_source: Callable[[], bytes] = fresh_key) -> dict:
    """Accept one client and run the conv workload on its ciphertext on
    ``device``.  ``key_source`` gives each ciphertext half's rLC key
    (os.urandom by default).  Returns the counts sent to the client."""
    dev = resolve_device(device)
    srv, conn = serve(port)
    try:
        send_obj(conn, WELCOME)
        params = recv_obj(conn)                    # {"q", "h"} public params
        if "q" not in params or "h" not in params:
            raise ValueError(f"bad public parameters: {sorted(params)}")
        with span("serve_conv"):
            ct = recv_ciphertensor(conn, dev)
            eng = HomomorphicEngine(prf_trunc_bytes=16)
            filt = CONV_FILTERS[filter_size]
            out_halves = [eng.conv2d(h, filt, key=key_source(), padding=1,
                                     stride=1) for h in ct]
            eng.flush_checks()
            if export_dir:
                eng.trace.export_json(export_dir)
            result = {"num_mults": int(eng.trace.num_mults),
                      "num_adds": int(eng.trace.num_adds)}
            send_obj(conn, result)
            send_ciphertensor(conn, CipherTensor(*out_halves))
        return result
    finally:
        conn.close()
        srv.close()


def client_main(port: int, image: np.ndarray, seed: int = 0,
                device=None) -> dict:
    """Connect, send the public parameters and the image encrypted on
    ``device`` with KeyPair.generate(Random(seed)) and Random(seed + 1),
    receive the result and the output ciphertext.  Returns the result."""
    from ..curve.host_ec import E2_ORDER

    dev = resolve_device(device)
    sock = connect(port)
    try:
        welcome = recv_obj(sock)
        if welcome != WELCOME:
            raise ValueError(f"unexpected greeting {welcome!r}")
        key = KeyPair.generate(random.Random(seed), device=dev)
        send_obj(sock, {"q": E2_ORDER,
                        "h": (int(key.h_host.x), int(key.h_host.y))})
        fixed = fixed_point.encode(fixed_point.min_max_scaling(image))
        ct = encrypt_batch(fixed, key, random.Random(seed + 1))
        send_ciphertensor(sock, ct)
        result = recv_obj(sock)
        recv_ciphertensor(sock, dev)
        return result
    finally:
        sock.close()
