"""The port's sharded prover (vpin_tpu_torch/parallel) against vpin_tpu's.

Each sharded entry on an 8-shard CPU mesh, Mesh((cpu,) * 8), must give
the same bits as vpin_tpu.parallel.ops's entry under vpin_tpu's 8-device
CPU mesh (tests/conftest.py forces it) at tests/test_parallel.py's sizes,
and as the port's single-device function.  Without a mesh, and for a shape
that does not divide, each entry returns None and its caller's result is
the same.  The 2-add golden fixtures replay under the mesh to
crosscheck/golden/'s bytes, with the sharded entries engaged.

Tolerance: exact (limbs bit for bit, points as encodings, proofs as bytes).
Slow tier: the port's dryrun_multichip on the 8-shard mesh (the 2-mult
witness scan, about 10^5 serial plain K1 calls, and two proofs).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vpin_tpu.commit.pedersen import MultiCommitGens as JGens
from vpin_tpu.curve.msm import build_table as j_build_table
from vpin_tpu.curve.msm import host_digits as j_host_digits
from vpin_tpu.curve.ristretto import RISTRETTO as JR
from vpin_tpu.field.prime_field import FQ as JFQ
from vpin_tpu.parallel import ops as jops
from vpin_tpu.parallel import use_mesh as j_use_mesh
from vpin_tpu.parallel.mesh import default_mesh as j_default_mesh
from vpin_tpu.sumcheck.sumcheck import _ROUND_PARTIALS
from vpin_tpu_torch import convert
from vpin_tpu_torch.commit.pedersen import MultiCommitGens
from vpin_tpu_torch.curve import msm
from vpin_tpu_torch.curve.ristretto import RISTRETTO as R
from vpin_tpu_torch.curve.rpoint import pointe_from_host
from vpin_tpu_torch.field import FQ
from vpin_tpu_torch.field.prime_field import L_MODULUS as L
from vpin_tpu_torch.gadgets import point_addition_gadget
from vpin_tpu_torch.parallel import (
    ENGAGED, Mesh, default_mesh, get_mesh, mesh_axis_size, ops, set_mesh,
    use_mesh,
)
from vpin_tpu_torch.poly import dense
from vpin_tpu_torch.snark.r1cs import regular_reduce
from vpin_tpu_torch.sumcheck.sumcheck import round_evals, round_sums
from test_torch_snark import add_fixture_trace, replay
from test_torch_spark import replay_full

CPU = torch.device("cpu")
MESH8 = Mesh((CPU,) * 8)
RS = np.random.RandomState(17)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(n):
    return [int.from_bytes(RS.bytes(32), "little") % L for _ in range(n)]


def _table(n):
    vals = _ints(n)
    return FQ.to_mont(vals, CPU), JFQ.to_mont(vals)


def _port(t):
    return [int(v) for v in FQ.from_mont(t).reshape(-1)]


def _jax_limbs(a):
    return convert.tensor_from_jax(np.asarray(a), CPU)


def _engaged(entry, fn):
    before = ENGAGED[entry]
    out = fn()
    return out, ENGAGED[entry] - before


# ----------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------

def test_mesh_is_opt_in_and_default_mesh_raises():
    assert get_mesh() is None and mesh_axis_size() == 1
    with use_mesh(MESH8) as m:
        assert get_mesh() is m and mesh_axis_size() == 8
        assert m.devices == (CPU,) * 8 and m.distinct == (CPU,)
        with use_mesh(None):
            assert mesh_axis_size() == 1
        assert get_mesh() is m
    assert get_mesh() is None
    set_mesh(MESH8)
    try:
        assert mesh_axis_size() == 8
    finally:
        set_mesh(None)
    assert default_mesh(1, "cpu").devices == (CPU,)
    assert default_mesh(device_type="cpu").devices == (CPU,)
    with pytest.raises(RuntimeError, match="asked for"):
        default_mesh(2, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="asked for"):
            default_mesh()
    else:
        with pytest.raises(RuntimeError, match="asked for"):
            default_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        Mesh(())


# ----------------------------------------------------------------------
# each entry against vpin_tpu's and the port's single-device function
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind, k", [("quad", 2), ("cubic", 3),
                                     ("cubic_additive", 4)])
def test_sharded_round_evals(kind, k):
    n = 128                                   # n2 = 64, 8 rows a shard
    pairs = [_table(n) for _ in range(k)]
    tabs = [p for p, _ in pairs]
    with use_mesh(MESH8):
        got, engaged = _engaged("round_evals",
                                lambda: ops.sharded_round_evals(kind, tabs))
        via_caller = round_evals(kind, tabs)
    assert engaged == 1
    with j_use_mesh(j_default_mesh(8)):
        jgot = jops.sharded_round_evals(_ROUND_PARTIALS[kind],
                                        tuple(j for _, j in pairs))
    assert jgot is not None
    want = round_sums(kind, tabs)
    assert torch.equal(got, want)
    assert torch.equal(got, _jax_limbs(jnp.stack(jgot)))
    assert via_caller == _port(want)


def test_sharded_bound_top():
    Z, jZ = _table(64)
    r = _ints(1)[0]
    with use_mesh(MESH8):
        got, engaged = _engaged("bound_top",
                                lambda: ops.sharded_bound_top(Z, r))
        via_caller = dense.bound_top(Z, r)
    assert engaged == 1
    with j_use_mesh(j_default_mesh(8)):
        jgot = jops.sharded_bound_top(jZ, JFQ.to_mont([r])[0])
    assert jgot is not None
    want = dense.bound_top(Z, r)
    assert torch.equal(got, want) and torch.equal(via_caller, want)
    assert torch.equal(got, _jax_limbs(jgot))
    zs = _port(Z)
    assert _port(got) == [(a + r * (b - a)) % L for a, b in zip(zs[:32],
                                                                 zs[32:])]


def test_sharded_msm_digits():
    rows, n = 8, 4
    gens = MultiCommitGens.new(n, b"test_parallel_msm")
    table = msm.build_table(R, pointe_from_host(gens.Gh, CPU))
    scalars = [_ints(n) for _ in range(rows)]
    digits = torch.as_tensor(np.stack([msm.host_digits(s) for s in scalars]))
    with use_mesh(MESH8):                     # the caller takes the entry
        got, engaged = _engaged("msm_digits", lambda: msm.msm_digits(
            R, table, digits))
    assert engaged == 1
    jgens = JGens.new(n, b"test_parallel_msm")
    jtable = j_build_table(JR, jgens.G, n)
    jdigits = jnp.asarray(np.stack([j_host_digits(s) for s in scalars]))
    with j_use_mesh(j_default_mesh(8)):
        jgot = jops.sharded_msm_digits(JR, jtable, jdigits)
    assert jgot is not None
    want = msm.msm_digits(R, table, digits)
    # one ed_msm a row on every route: the same limbs, and vpin_tpu's
    # sums (another association) encode alike
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert R.encode_bytes(got) == JR.encode_bytes(jgot)


def test_sharded_regular_reduce():
    nseg, k, nz = 16, 4, 32
    vals, jvals = _table(nseg * k)
    vals, jvals = vals.reshape(nseg, k, 8), jvals.reshape(nseg, k, 16)
    idx_np = RS.randint(nz, size=(nseg, k)).astype(np.int32)
    z, jz = _table(nz)
    idx = torch.as_tensor(idx_np, dtype=torch.int64)
    with use_mesh(MESH8):
        got, engaged = _engaged("regular_reduce",
                                lambda: ops.sharded_regular_reduce(
                                    vals, idx, z, nseg))
    assert engaged == 1
    with j_use_mesh(j_default_mesh(8)):
        jgot = jops.sharded_regular_reduce(jvals, jnp.asarray(idx_np), jz,
                                           nseg)
    assert jgot is not None
    want = regular_reduce(vals, idx, z)
    assert torch.equal(got, want) and torch.equal(got, _jax_limbs(jgot))
    vh, zh = _port(vals), _port(z)
    assert _port(got) == [sum(vh[s * k + j] * zh[idx_np[s, j]]
                              for j in range(k)) % L for s in range(nseg)]


# ----------------------------------------------------------------------
# None without a mesh and for a shape that does not divide
# ----------------------------------------------------------------------

def _msm_case(rows):
    gens = MultiCommitGens.new(4, b"test_parallel_msm")
    table = msm.build_table(R, pointe_from_host(gens.Gh, CPU))
    digits = torch.as_tensor(np.stack([msm.host_digits(_ints(4))
                                       for _ in range(rows)]))
    return (lambda: ops.sharded_msm_digits(R, table, digits),
            lambda: R.encode_bytes(msm.msm_digits(R, table, digits)))


def _round_case(n):
    tabs = [_table(n)[0] for _ in range(3)]
    return (lambda: ops.sharded_round_evals("cubic", tabs),
            lambda: round_evals("cubic", tabs))


def _bound_case(n):
    Z, r = _table(n)[0], _ints(1)[0]
    return (lambda: ops.sharded_bound_top(Z, r),
            lambda: _port(dense.bound_top(Z, r)))


def _reduce_case(nseg):
    """SparseMat.multiply_vec over rows of 3 nonzeros each: one bucket of
    nseg segments."""
    from vpin_tpu_torch.snark.r1cs import SparseMat
    rows = np.repeat(np.arange(nseg), 3)
    cols = RS.randint(16, size=3 * nseg)
    mat = SparseMat((rows, cols, np.array(_ints(3 * nseg), dtype=object)),
                    nseg, 16)
    z = _table(16)[0]
    vals = FQ.zeros((nseg, 3), CPU)
    idx = torch.zeros((nseg, 3), dtype=torch.int64)
    return (lambda: ops.sharded_regular_reduce(vals, idx, z, nseg),
            lambda: _port(mat.multiply_vec(16, z)))


@pytest.mark.parametrize("make, odd", [
    (_msm_case, 6), (_round_case, 24), (_bound_case, 24), (_reduce_case, 12)],
    ids=["msm_digits", "round_evals", "bound_top", "regular_reduce"])
def test_entry_declines_and_the_caller_agrees(make, odd):
    """None without a mesh, with one shard and where 8 does not divide the
    axis; the caller then runs its single-device code, to the same result
    (the engaged route's results are held above)."""
    entry, result = make(odd)
    before = dict(ENGAGED)
    single = result()
    assert entry() is None                      # no mesh
    with use_mesh(Mesh((CPU,))):
        assert entry() is None                  # one shard
    with use_mesh(MESH8):
        assert entry() is None                  # 8 does not divide it
        assert result() == single
    assert ENGAGED == before


# ----------------------------------------------------------------------
# the golden fixtures under the mesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True],
                         ids=["transparent", "full_snark"])
def test_add_golden_fixture_replays_under_the_mesh(full):
    """Under the mesh every table is a tensor; both challenge streams and
    the proof bytes stay the golden ones, and the sharded entries ran."""
    before = dict(ENGAGED)
    with use_mesh(MESH8):
        gadget = point_addition_gadget(*add_fixture_trace(), device="cpu")
        if full:
            blob = replay_full(gadget,
                               "point_add_cp_full_snark_challenges.json")[0]
        else:
            blob = replay(gadget, "point_add_cp_challenges.json")[1]
    assert len(blob) == (16880 if full else 4672)
    engaged = {k: ENGAGED[k] - before[k] for k in ENGAGED}
    assert all(engaged[k] > 0 for k in ("round_evals", "bound_top",
                                        "regular_reduce")), engaged
    if full:
        assert engaged["msm_digits"] > 0, engaged


# the 2-mult witness scan (about 10^5 serial plain K1 calls) and two proofs
@pytest.mark.slow
def test_dryrun_multichip_on_eight_cpu_shards():
    from vpin_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(MESH8, "cpu")
    assert out["proof_bytes"] == 11840 and out["constraints"] == 6928
    assert all(v > 0 for v in out["engaged"].values()), out["engaged"]
