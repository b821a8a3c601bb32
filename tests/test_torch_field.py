"""Port field arithmetic (vpin_tpu_torch on the CPU, where kernel K1's wrapper
runs its plain PyTorch version) against vpin_tpu's JAX limb arithmetic.

Tolerance: exact.  Integer field arithmetic leaves no room for one, so every
result must be the same canonical limbs, bit for bit.
"""

import random

import jax
import numpy as np
import pytest
import torch

from vpin_tpu.curve.ristretto import RISTRETTO as JR
from vpin_tpu.field import FP as JFP, FQ as JFQ
from vpin_tpu_torch import convert, kernels
from vpin_tpu_torch.curve.ristretto import RISTRETTO as R
from vpin_tpu_torch.device import resolve_device
from vpin_tpu_torch.field import FP, FQ
from vpin_tpu_torch.field.cuda_mont import (
    mont_mul, mont_mul_plain, mont_pow, mont_pow_plain,
)
from vpin_tpu_torch.field.limbs import (
    ints_to_limbs, limbs_to_ints, to_numpy, to_tensor,
)

FIELDS = [(FQ, JFQ), (FP, JFP)]
IDS = ["Fl", "Fp"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run thousands of ops on tiny tensors, where torch's
    intra-op threads cost more than they give (the suite's workers already
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def edge_values(mod):
    """0, 1, N-1 and friends, and values whose limbs are all ones below N."""
    top = mod >> 224
    edges = [0, 1, 2, mod - 1, mod - 2, (mod - 1) // 2, 2**128, 2**252 % mod,
             ((top - 1) << 224) | (2**224 - 1), mod - 2**32]
    return edges + [(1 << k) - 1 for k in range(16, mod.bit_length(), 16)]


def operands(mod, n, seed):
    rng = random.Random(seed)
    edges = edge_values(mod)
    return edges + [rng.randrange(mod) for _ in range(n - len(edges))]


def port(arr):
    return convert.tensor_from_jax(np.asarray(arr), "cpu")


def assert_bit_equal(got: torch.Tensor, want_jax) -> None:
    assert got.dtype == torch.int32
    assert np.array_equal(convert.tensor_to_jax(got), np.asarray(want_jax))


@pytest.mark.parametrize("F,J", FIELDS, ids=IDS)
def test_mul_matches_jax(F, J):
    xs = operands(F.modulus, 64, 1)
    ys = list(reversed(operands(F.modulus, 64, 2)))
    a, b = J.to_mont(xs), J.to_mont(ys)
    want = jax.jit(J._mul_jnp)(a, b)
    got = mont_mul(port(a), port(b), F)
    assert_bit_equal(got, want)
    assert [int(v) for v in F.from_mont(got)] == [
        x * y % F.modulus for x, y in zip(xs, ys)]


@pytest.mark.parametrize("F,J", FIELDS, ids=IDS)
def test_mul_edge_pairs_match_jax(F, J):
    """Every pair of edge operands, in Montgomery form and as raw limbs."""
    edges = edge_values(F.modulus)
    xs = [x for x in edges for _ in edges]
    ys = [y for _ in edges for y in edges]
    raw_a = np.asarray(J.to_limb_array(xs))
    raw_b = np.asarray(J.to_limb_array(ys))
    want = jax.jit(J._mul_jnp)(raw_a, raw_b)
    got = mont_mul_plain(port(raw_a), port(raw_b), F)
    assert_bit_equal(got, want)
    r_inv = pow(1 << 256, -1, F.modulus)
    assert [int(v) for v in limbs_to_ints(to_numpy(got))] == [
        x * y * r_inv % F.modulus for x, y in zip(xs, ys)]


@pytest.mark.parametrize("F,J", FIELDS, ids=IDS)
def test_add_sub_neg_match_jax(F, J):
    xs = operands(F.modulus, 48, 3)
    ys = list(reversed(operands(F.modulus, 48, 4)))
    a, b = J.to_mont(xs), J.to_mont(ys)
    pa, pb = port(a), port(b)
    assert_bit_equal(F.add(pa, pb), jax.jit(J.add)(a, b))
    assert_bit_equal(F.sub(pa, pb), jax.jit(J.sub)(a, b))
    assert_bit_equal(F.neg(pa), jax.jit(J.neg)(a))


@pytest.mark.parametrize("F,J", FIELDS, ids=IDS)
def test_inv_matches_jax(F, J):
    xs = operands(F.modulus, 24, 5)             # includes 0: inv(0) == 0
    a = J.to_mont(xs)
    got = F.inv(port(a))
    assert_bit_equal(got, jax.jit(J.inv)(a))
    assert [int(v) for v in F.from_mont(got)] == [
        pow(x, F.modulus - 2, F.modulus) for x in xs]


#: mont_pow's exponents on the main path: Fermat inversion in both fields
#: and ristretto255's square root (p - 5) / 8
POW_CASES = [(FQ, JFQ, FQ._inv_exp_bits, JFQ._inv_exp_bits),
             (FP, JFP, FP._inv_exp_bits, JFP._inv_exp_bits),
             (FP, JFP, R._sqrt_exp_bits, JR._sqrt_exp_bits)]


@pytest.mark.parametrize("F,J,bits,jbits", POW_CASES,
                         ids=["Fl-inv", "Fp-inv", "Fp-sqrt"])
def test_mont_pow_plain_matches_jax_pow_bits(F, J, bits, jbits):
    """The plain mont_pow against vpin_tpu's pow_bits scan, on 0, 1, N - 1,
    the other edges and random values."""
    assert bits == jbits
    xs = operands(F.modulus, 20, 7)
    a = J.to_mont(xs)
    got = mont_pow_plain(port(a), bits, F)
    assert_bit_equal(got, jax.jit(lambda v: J.pow_bits(v, jbits))(a))
    e = int("".join(map(str, bits)), 2)
    assert [int(v) for v in F.from_mont(got)] == [
        pow(x, e, F.modulus) for x in xs]


def test_mont_pow_routes_and_edges():
    """pow_bits and inv take mont_pow, whose CPU route is the plain version;
    leading zero bits and the empty exponent give the same as the shorter
    exponent and 1; exponents over 256 bits are refused."""
    a = FQ.to_mont([0, 1, 5, FQ.modulus - 1], "cpu")
    bits = (1, 0, 1, 1)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(FQ.pow_bits(a, bits), mont_pow_plain(a, bits, FQ))
    assert torch.equal(mont_pow(a, (0, 0) + bits, FQ),
                       mont_pow_plain(a, bits, FQ))
    assert torch.equal(FQ.inv(a), mont_pow(a, FQ._inv_exp_bits, FQ))
    assert torch.equal(mont_pow(a, (), FQ), FQ.ones((4,), "cpu"))
    assert kernels.LAUNCHES == before
    assert [int(v) for v in FQ.from_mont(FQ.inv(a))] == [
        0, 1, pow(5, -1, FQ.modulus), FQ.modulus - 1]
    with pytest.raises(ValueError):
        mont_pow(a, (1,) * 257, FQ)
    with pytest.raises(ValueError):
        mont_pow(a, (2,), FQ)


@pytest.mark.parametrize("F,J", FIELDS, ids=IDS)
def test_to_from_mont_match_jax(F, J):
    xs = operands(F.modulus, 32, 6)
    shaped = np.asarray(xs, dtype=object).reshape(4, 8)
    got = F.to_mont(shaped, "cpu")
    want = J.to_mont(shaped)
    assert got.shape == (4, 8, 8)
    assert_bit_equal(got, want)
    assert [int(v) for v in F.from_mont(got).reshape(-1)] == [
        int(v) for v in np.asarray(J.from_mont(want)).reshape(-1)]
    assert [int(v) for v in F.from_mont(got).reshape(-1)] == xs


def test_limb_repack_roundtrip():
    rng = np.random.RandomState(0)
    limbs16 = rng.randint(0, 1 << 16, size=(5, 3, 16)).astype(np.uint32)
    t = convert.tensor_from_jax(limbs16, "cpu")
    assert t.shape == (5, 3, 8) and t.dtype == torch.int32
    assert np.array_equal(convert.tensor_to_jax(t), limbs16)
    vals = [0, 1, (1 << 256) - 1, 1 << 255, 12345678901234567890]
    assert [int(v) for v in limbs_to_ints(ints_to_limbs(vals))] == vals
    assert [int(v) for v in limbs_to_ints(to_numpy(to_tensor(
        ints_to_limbs(vals), "cpu")))] == vals


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = FQ.to_mont([1, 2], "cpu")
    with pytest.raises(TypeError):
        mont_mul(a.to(torch.int64), a, FQ)
    with pytest.raises(ValueError):
        mont_mul(a.reshape(1, 16), a.reshape(1, 16), FQ)
    with pytest.raises(ValueError):
        mont_mul(torch.empty((2, 8), dtype=torch.int32, device="meta"),
                 torch.empty((2, 8), dtype=torch.int32, device="meta"), FQ)


def test_cpu_tensors_take_the_plain_version():
    before = dict(kernels.LAUNCHES)
    a = FQ.to_mont([3, 5], "cpu")
    assert torch.equal(mont_mul(a, a, FQ), mont_mul_plain(a, a, FQ))
    assert kernels.LAUNCHES == before


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            FQ.to_mont([1])
    assert resolve_device("cpu").type == "cpu"
