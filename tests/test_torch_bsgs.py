"""The port's BSGS decryption (vpin_tpu_torch.nn.bsgs and
elgamal.decrypt_batch) on the CPU, where K1-K3 run their plain PyTorch
versions.

Tolerance: exact.  The table's keys are held against the reference's numpy
key mix of host j*G (curve/host_ec.py), its cache against vpin_tpu's reader
and writer byte for byte, and decryption against the known messages.  The
slow tier builds the table in vpin_tpu too (an XLA compile of minutes on
the CPU) and requires equal arrays and equal cache bytes.
"""

import pickle
import random

import numpy as np
import pytest
import torch

from vpin_tpu_torch.curve.host_ec import (
    E2_G_HOST, E2_HOST, HostPoint, host_infinity,
)
from vpin_tpu_torch.curve.weierstrass import E2
from vpin_tpu_torch.field.limbs import ints_to_limbs, to_tensor
from vpin_tpu_torch.nn import KeyPair, decrypt_batch, encrypt_batch
from vpin_tpu_torch.nn.bsgs import BsgsTable, _mix_keys, giant_stride, mix_keys

M, CHUNK = 4096, 1024


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def host_multiples(m):
    """(xs, ys) of j*G for j in [1, m) in host ints, by doubling blocks:
    block t adds size*G to every point so far, with one inversion for the
    block (Montgomery's trick)."""
    p = E2_HOST.p
    xs, ys = [E2_G_HOST.x], [E2_G_HOST.y]
    while len(xs) < m - 1:
        size = len(xs)
        n = min(size, m - 1 - size)
        Q = size * E2_G_HOST
        # x differs from Q's but for j = size, which is a doubling
        dx = [(Q.x - x) % p for x in xs[:n]]
        pre, acc = [], 1
        for d in dx:
            pre.append(acc)
            acc = acc * (d or 1) % p
        inv, invs = pow(acc, -1, p), [0] * n
        for i in range(n - 1, -1, -1):
            invs[i] = inv * pre[i] % p
            inv = inv * (dx[i] or 1) % p
        for i in range(n):
            if dx[i] == 0:
                R = HostPoint(E2_HOST, xs[i], ys[i]) + Q
                xs.append(R.x)
                ys.append(R.y)
                continue
            s = (Q.y - ys[i]) * invs[i] % p
            x3 = (s * s - xs[i] - Q.x) % p
            xs.append(x3)
            ys.append((s * (xs[i] - x3) - ys[i]) % p)
    return xs, ys


def host_table(m):
    """The reference's arrays for j in [1, m), from host j*G: (keys sorted
    unsigned, perm), ties in stable order."""
    keys = _mix_keys(*host_multiples(m))
    order = np.argsort(keys, kind="stable")
    return keys[order], np.arange(1, m, dtype=np.int64)[order]


@pytest.fixture(scope="module")
def truth():
    return host_table(M)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's table, built on the CPU and written to a cache."""
    path = tmp_path_factory.mktemp("bsgs") / "port.pkl"
    return BsgsTable.build(M, CHUNK, cache_path=str(path), device="cpu"), path


@pytest.fixture(scope="module")
def keypair():
    return KeyPair.generate(random.Random(1), device="cpu")


def test_table_keys_equal_host_mix(built, truth):
    table, _ = built
    keys, perm = truth
    assert table.m == M
    assert table.keys_sorted.dtype == np.uint64 and table.perm.dtype == np.int64
    assert np.array_equal(table.keys_sorted, keys)
    assert np.array_equal(table.perm, perm)


def test_device_key_mix_equals_numpy():
    rs = np.random.RandomState(7)
    xs = [int(v) for v in rs.randint(0, 2**62, size=300, dtype=np.int64)]
    xs = [v << 2 | 3 for v in xs] + [0, 1, 2**63, 2**64 - 1, 2**64,
                                     2**255 - 1, 2**252 + 12345]
    ys = xs[::-1]
    x = to_tensor(ints_to_limbs(xs), "cpu")
    y = to_tensor(ints_to_limbs(ys), "cpu")
    got = mix_keys(x, y).numpy().view(np.uint64)
    assert np.array_equal(got, _mix_keys(xs, ys))


def test_port_cache_loads_in_vpin_tpu(built, truth, monkeypatch):
    """vpin_tpu reads the port's cache as its own (no XLA work: the build
    returns before any device op), and the bytes are those vpin_tpu
    writes for the same arrays."""
    from vpin_tpu.nn import bsgs as jbsgs

    def no_device_build(*args, **kwargs):
        raise AssertionError("vpin_tpu built the table instead of reading it")

    _, path = built
    monkeypatch.setattr(jbsgs.E2, "padd", no_device_build)
    jtable = jbsgs.BsgsTable.build(M, cache_path=str(path))
    keys, perm = truth
    assert np.array_equal(jtable.keys_sorted, keys)
    assert np.array_equal(jtable.perm, perm)
    assert path.read_bytes() == pickle.dumps({"m": M, "keys": keys,
                                              "perm": perm})


def test_reference_cache_loads_in_port(truth, tmp_path, keypair):
    keys, perm = truth
    path = tmp_path / "ref.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"m": M, "keys": keys, "perm": perm}, fh)
    table = BsgsTable.build(M, cache_path=str(path), device="cpu")
    assert np.array_equal(table.keys_sorted, keys)
    assert np.array_equal(table.perm, perm)
    # its device copy works: a lookup round trip through decryption
    ct = encrypt_batch([-4095, 77], keypair, random.Random(3))
    assert decrypt_batch(ct, keypair, table, max_steps=8).tolist() == [-4095, 77]
    # a cache for another m is not taken
    other = BsgsTable.build(256, cache_path=str(path), device="cpu")
    assert other.m == 256 and len(other.keys_sorted) == 255


def test_host_multiples_are_successive_additions():
    xs, ys = host_multiples(300)
    P = E2_G_HOST
    for x, y in zip(xs, ys):
        assert (x, y) == (P.x, P.y)
        P = P + E2_G_HOST
    assert len(xs) == 299


@pytest.mark.parametrize("n, max_steps, want", [
    (1024, 3_200_000, 2048), (64, 3_200_000, 4096), (16, 3_200_000, 4096),
    (10, 3_200_000, 4096), (4, 2048, 32), (1, 1 << 16, 128)])
def test_giant_stride(n, max_steps, want):
    """The reference's adaptive stride (vpin_tpu/nn/bsgs.py dlog_batch):
    CNN A's four decryptions at m = 3,200,000, and small caps."""
    assert giant_stride(n, max_steps) == want


def test_dlog_batch_known_values(built):
    table, _ = built
    vals = [0, 1, -1, M - 1, -(M - 1), M, -M, M + 1, 2 * M, -3 * M,
            123456, -123457, 40 * M + 3]
    pts = E2.from_affine_host([v * E2_G_HOST if v else host_infinity()
                               for v in vals], "cpu")
    assert table.dlog_batch(pts, max_steps=64) == vals
    assert table.last_rounds == 2          # 40 giant steps: round 40 // 32


def test_dlog_batch_default_stride(built):
    """max_steps defaults to m: the adaptive stride gives K = 32 here, so
    100 giant steps take round 100 // 32 = 3."""
    table, _ = built
    vals = [100 * M + 5, -7]
    pts = E2.from_affine_host([v * E2_G_HOST for v in vals], "cpu")
    assert table.dlog_batch(pts) == vals
    assert table.last_rounds == 4


def test_decrypt_batch_known_messages(built, keypair):
    table, _ = built
    msgs = np.array([[0, 1, -1, 5], [M, -M, 3 * M + 2, -123456]])
    ct = encrypt_batch(msgs, keypair, random.Random(2))
    got = decrypt_batch(ct, keypair, table, max_steps=64)
    assert got.shape == (2, 4) and got.dtype == object
    assert got.tolist() == msgs.tolist()


def test_dlog_not_found_raises(built):
    table, _ = built
    pts = E2.from_affine_host([40 * M * E2_G_HOST], "cpu")
    with pytest.raises(ValueError, match="not found within 8 giant steps"):
        table.dlog_batch(pts, max_steps=8)


def test_verification_sweep_catches_a_wrong_table(truth):
    """A table whose perm is off by one answers wrong js; the sweep's
    scalar multiplication raises instead of returning them."""
    keys, perm = truth
    bad = BsgsTable(M, keys, perm + 1)
    pts = E2.from_affine_host([5 * E2_G_HOST], "cpu")
    with pytest.raises(ValueError, match="verification failed"):
        bad.dlog_batch(pts, max_steps=4)


# ----------------------------------------------------------------------
# slow tier: vpin_tpu builds the same table
# ----------------------------------------------------------------------

# vpin_tpu's table build on the CPU is an XLA compile of about 1.5 min
@pytest.mark.slow
def test_vpin_tpu_build_equals_port(built, tmp_path):
    from vpin_tpu.nn.bsgs import BsgsTable as JBsgsTable
    from vpin_tpu_torch import convert
    table, path = built
    jpath = tmp_path / "jax.pkl"
    jtable = JBsgsTable.build(M, CHUNK, cache_path=str(jpath))
    assert jpath.read_bytes() == path.read_bytes()
    port = convert.bsgs_table_from_jax(jtable)
    assert np.array_equal(port.keys_sorted, table.keys_sorted)
    assert np.array_equal(port.perm, table.perm)
    back = JBsgsTable(*convert.bsgs_table_to_jax(table))
    assert np.array_equal(back.keys_sorted, jtable.keys_sorted)
    assert np.array_equal(back.perm, jtable.perm)
