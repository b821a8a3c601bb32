"""The port's socket transport and two-process conv (vpin_tpu_torch/nn/
transport.py, nn/socket_runner.py, the CLI's serve-conv and client-conv) on
the CPU, against vpin_tpu's wire format and the in-process conv.

Tolerance: exact.  Payloads are vpin_tpu's (..., 16)-limb numpy arrays and
must decode to the same points in either package; the socket conv's trace
must equal, entry for entry, the in-process run's on the same ciphertext
with the same rLC keys.

Slow tier: the CLI pair as two processes (two imports of torch and a 4x4
conv on each side) and a vpin_tpu client talking to the port's server
(vpin_tpu's JAX encryption compiles on the CPU).
"""

import os
import random
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER
from vpin_tpu_torch.curve.weierstrass import E2
from vpin_tpu_torch.nn import transport
from vpin_tpu_torch.nn.elgamal import CipherTensor, KeyPair
from vpin_tpu_torch.nn.models import run_conv_workload
from vpin_tpu_torch.nn.socket_runner import client_main, server_main
from vpin_tpu_torch.runner.proof_runner import (
    load_point_add_json, load_point_mult_json, trace_args,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_points(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(1, E2_ORDER) * E2_G_HOST for _ in range(n)]


def _affine(points):
    return [(bool(P.inf),) + ((0, 0) if P.inf else (int(P.x), int(P.y)))
            for P in points]


def test_chunked_round_trip_over_localhost():
    port = free_port()
    blob = {"data": bytes(range(256)) * 400, "n": 7}     # > 30,000 B pickled
    got = {}

    def serve():
        srv, conn = transport.serve(port)
        try:
            got["obj"] = transport.recv_obj(conn)
            transport.send_obj(conn, "ok")
        finally:
            conn.close()
            srv.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    sock = transport.connect(port)
    try:
        transport.send_obj(sock, blob)
        assert transport.recv_obj(sock) == "ok"
    finally:
        sock.close()
    t.join(timeout=30)
    assert got["obj"] == blob
    assert len(__import__("pickle").dumps(blob)) > 3 * transport.CHUNK


def test_payloads_read_across_packages():
    """The port's payload through vpin_tpu's reader, and vpin_tpu's through
    the port's, give the same points."""
    from vpin_tpu.curve.weierstrass import E2 as JE2
    from vpin_tpu.nn.elgamal import CipherTensor as JCipherTensor
    from vpin_tpu.nn.transport import ciphertensor_to_payload as jpayload
    from vpin_tpu.nn.transport import payload_to_ciphertensor as jread
    a, b = _host_points(5, 1), _host_points(5, 2)
    a[1] = 0 * E2_G_HOST                                 # the identity
    c1 = [P + Q for P, Q in zip(a, b)]
    c2 = [P + P for P in b]

    # the port's sums have z != 1: the payload carries projective limbs
    port_ct = CipherTensor(
        E2.add(E2.from_affine_host(a, "cpu"), E2.from_affine_host(b, "cpu")),
        E2.add(E2.from_affine_host(b, "cpu"), E2.from_affine_host(b, "cpu")))
    payload = transport.ciphertensor_to_payload(port_ct)
    assert all(x.dtype == np.uint32 and x.shape == (5, 16)
               for half in ("c1", "c2") for x in payload[half])
    back = jread(payload)
    assert _affine(JE2.to_affine_host(back.c1)) == _affine(c1)
    assert _affine(JE2.to_affine_host(back.c2)) == _affine(c2)

    tuples = []
    for pts in (a, b):             # vpin_tpu's own (x, y, inf) host points
        arr = np.empty(len(pts), dtype=object)
        arr[:] = [(int(P.x), int(P.y), bool(P.inf)) for P in pts]
        tuples.append(arr)
    ref_ct = JCipherTensor(JE2.from_affine_host(tuples[0]),
                           JE2.from_affine_host(tuples[1]))
    got = transport.payload_to_ciphertensor(jpayload(ref_ct), "cpu")
    assert _affine(E2.to_affine_host(got.c1)) == _affine(a)
    assert _affine(E2.to_affine_host(got.c2)) == _affine(b)


def _keys():
    keys = iter((b"\x05" * 32, b"\x06" * 32))
    return lambda: next(keys)


def _assert_trace_equals(export_dir, fin):
    add, mult = trace_args(fin)
    assert tuple(load_point_add_json(export_dir)) == add
    assert tuple(load_point_mult_json(export_dir)) == mult


def test_socket_conv_equals_in_process(tmp_path):
    port, seed = free_port(), 3
    img = np.random.RandomState(seed).uniform(0.0, 1.0, (2, 2)).astype(
        np.float32)
    out, err = {}, []

    def run_server():
        try:
            out.update(server_main(port, export_dir=str(tmp_path / "x"),
                                   device="cpu", key_source=_keys()))
        except Exception as e:              # pragma: no cover
            err.append(e)

    t = threading.Thread(target=run_server, daemon=True)
    t.start()
    res = client_main(port, img, seed=seed, device="cpu")
    t.join(timeout=600)
    assert not err, err
    assert res == out == {"num_mults": 18, "num_adds": 16}
    key = KeyPair.generate(random.Random(seed), device="cpu")
    ref = run_conv_workload(img, 3, key, random.Random(seed + 1),
                            key_source=_keys())
    _assert_trace_equals(str(tmp_path / "x"), ref.trace.finalize())


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               VPIN_REFERENCE=str(ROOT / "no"))
    return [sys.executable, "-m", "vpin_tpu_torch.runner.cli", *args], env


@pytest.mark.slow
def test_cli_serve_and_client_as_two_processes(tmp_path):
    port = free_port()
    cmd, env = _cli("serve-conv", "--port", str(port), "--export",
                    str(tmp_path / "x"), "--device", "cpu")
    server = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, text=True)
    try:
        cmd, env = _cli("client-conv", "--port", str(port), "--size", "4",
                        "--seed", "2", "--device", "cpu")
        client = subprocess.run(cmd, env=env, capture_output=True, text=True,
                                timeout=600)
        assert client.returncode == 0, client.stderr
        assert "{'num_mults': 18, 'num_adds': 16}" in client.stdout
        sout, _ = server.communicate(timeout=600)
    finally:
        server.kill()
    assert server.returncode == 0
    assert "Number of EC point multiplications: 18" in sout
    assert "Number of EC point additions: 16" in sout
    assert (tmp_path / "x" / "pointAdd" / "point_add_px_byte.json").exists()


@pytest.mark.slow
def test_vpin_tpu_client_talks_to_the_port_server(tmp_path):
    from vpin_tpu.nn.socket_runner import client_main as jclient
    port, seed = free_port(), 4
    img = np.random.RandomState(seed).uniform(0.0, 1.0, (4, 4)).astype(
        np.float32)
    out, err = {}, []

    def run_server():
        try:
            out.update(server_main(port, export_dir=str(tmp_path / "x"),
                                   device="cpu", key_source=_keys()))
        except Exception as e:              # pragma: no cover
            err.append(e)

    t = threading.Thread(target=run_server, daemon=True)
    t.start()
    res = jclient(port, img, seed=seed)
    t.join(timeout=900)
    assert not err, err
    assert res == out == {"num_mults": 18, "num_adds": 16}
    # vpin_tpu's client encrypts with the same draws as the port's
    key = KeyPair.generate(random.Random(seed), device="cpu")
    ref = run_conv_workload(img, 3, key, random.Random(seed + 1),
                            key_source=_keys())
    _assert_trace_equals(str(tmp_path / "x"), ref.trace.finalize())
