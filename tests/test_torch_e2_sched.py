"""The stage schedule of the K2 and K3 group kernels (vpin_tpu_torch/csrc/
e2_sched.cuh), as vpin_tpu_torch/curve/e2_sched.py lays it out for the
kernels, replayed on Python ints mod l.

The kernels run the program that e2_sched.build lays out: virtual lane v of
addition j on lane (v + j * width) % G, each lane's rows in table order, a
__syncwarp between stages.  This is the only check of the kernels' data flow
without a card: the replay must give vpin_tpu's limbs (its jitted
WeierstrassCurve._add_jnp) and the port's plain version, for one addition
and for the ladder step's pair, with 4 and 8 lanes, and the packed program
must hold the rows the replay ran.

Tolerance: exact.  Every field operation returns the canonical residue, so
a schedule of the same polynomials gives the same limbs.
"""

import jax
import numpy as np
import pytest
import torch

from vpin_tpu.curve.weierstrass import E2 as JE2
from vpin_tpu_torch import convert
from vpin_tpu_torch.curve import cuda_ec, e2_sched
from vpin_tpu_torch.curve.weierstrass import E2, PointW
from vpin_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints, to_numpy

from test_torch_curve import SPECIAL, rand_host_points


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain version runs many ops on tiny tensors (see
    test_torch_curve.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SLOTS, KINDS, ROWS, DEFINES = e2_sched.schedule()
MUL, ADD, SUB = (KINDS.index(k) for k in ("E2_MUL", "E2_ADD", "E2_SUB"))
TEMPS = e2_sched.temps()
L = E2.F.modulus
RINV = pow(1 << 256, -1, L)
K2_ADD, = e2_sched.modes("e2_add")[1]
K3_ADD, K3_DBL_PAIR = e2_sched.modes("e2_scalar_mul")[3]
K3_DBL, = e2_sched.modes("e2_scalar_mul")[2]
ACC, BASE = K3_ADD["out"], K3_DBL["out"]
build = e2_sched.build


def unpack(blob, G, nmodes):
    """The E2Prog bytes as csrc/e2.cuh declares the struct: per mode and
    stage, (each lane's rows, rounds)."""
    nops = DEFINES["E2_MAXOPS"] + 1
    shape = (DEFINES["E2_MODES"], DEFINES["E2_NSTAGE"], DEFINES["E2_MAXG"] + 1)
    op = np.frombuffer(blob[:4 * nops].tobytes(), "<u4")
    at = 4 * nops + 2 * int(np.prod(shape))
    start = np.frombuffer(blob[4 * nops:at].tobytes(), "<u2").reshape(shape)
    rounds = blob[at:at + shape[0] * shape[1]].reshape(shape[:2])
    assert len(blob) == -(-(at + shape[0] * shape[1]) // 16) * 16
    return [[([[(int(w) & 0xff, int(w) >> 8 & 0xff, int(w) >> 16 & 0xff,
                 int(w) >> 24) for w in op[start[m, s, l]:start[m, s, l + 1]]]
               for l in range(G)], int(rounds[m, s]))
             for s in range(shape[1])] for m in range(nmodes)]


def check_races(prog):
    """Inside a stage no lane reads or writes a slot another lane writes."""
    for s, (lanes, _) in enumerate(prog):
        for l, rows in enumerate(lanes):
            writes = {r[1] for r in rows}
            for o, other in enumerate(lanes):
                if o != l:
                    touched = {x for r in other for x in r[1:]}
                    assert not writes & touched, (s, l, o, writes & touched)


def replay(prog, slots, order=1):
    """Run the program on ints in Montgomery form, each stage's lanes in
    ``order``; each lane runs its product rounds, one product a round."""
    for lanes, rounds in prog:
        for rows in lanes[::order]:
            assert sum(r[0] == MUL for r in rows) <= rounds
            for kind, d, a, b in rows:
                x, y = slots[a], slots[b]
                slots[d] = (x * y * RINV if kind == MUL else
                            x + y if kind == ADD else x - y) % L
    return slots


def as_ints(P):
    return [limbs_to_ints(to_numpy(c)) for c in P]


def from_ints(cols):
    return [torch.from_numpy(ints_to_limbs([int(v) for v in c]).astype(
        np.int32)) for c in cols]


def run(prog, n, fill, out, order=1):
    """Replay ``prog`` on n elements; ``fill`` {slot: ints}; returns the
    out slots' ints."""
    res = [[] for _ in out]
    a, b3 = (int(limbs_to_ints(x[None])[0]) for x in (E2.A, E2.B3))
    for i in range(n):
        slots = [0] * (DEFINES["E2_EL_TEMP"] + 2 * TEMPS)
        slots[DEFINES["E2_EL_A"]], slots[DEFINES["E2_EL_B3"]] = a, b3
        for k, col in fill.items():
            slots[k] = int(col[i])
        slots = replay(prog, slots, order)
        for r, k in zip(res, out):
            r.append(slots[k])
    return res


@pytest.fixture(scope="module")
def points():
    """The special pairs of test_torch_curve.py, random affine pairs and
    projective ones (vpin_tpu sums, Z != 1), as vpin_tpu arrays."""
    jadd = jax.jit(JE2._add_jnp)
    Ps = [p for p, _ in SPECIAL] + rand_host_points(5)
    Qs = [q for _, q in SPECIAL] + rand_host_points(5)
    dP, dQ = JE2.from_affine_host(Ps), JE2.from_affine_host(Qs)
    R = jadd(dP, dQ)
    S = jadd(R, dQ)
    pairs = [(dP, dQ), (R, dQ), (R, S), (S, S)]
    return jadd, [(X, Y, jadd(X, Y)) for X, Y in pairs]


def port(P):
    return convert.point_from_jax([np.asarray(c) for c in P], "cpu")


@pytest.mark.parametrize("G", [4, 8])
def test_schedule_rounds_and_races(G):
    """One addition waits on 4 product rounds with 8 lanes and 6 with 4; the
    ladder step's pair on 6 and 9; no stage races between lanes, in K2's
    layout and in each of K3's step modes."""
    single = build(G, [K2_ADD])
    pair = build(G, [K3_ADD, K3_DBL_PAIR])
    assert sum(r for _, r in single) == {8: 4, 4: 6}[G]
    assert sum(r for _, r in pair) == {8: 6, 4: 9}[G]
    for prog in (single, pair, build(G, [K3_ADD]), build(G, [K3_DBL])):
        check_races(prog)
    # the bytes the kernels get hold these rows, mode by mode
    for kernel in ("e2_add", "e2_scalar_mul"):
        modes = e2_sched.modes(kernel)
        blob = e2_sched.pack(G, modes)
        assert unpack(blob, G, len(modes)) == [
            [(lanes, r) for lanes, r in build(G, maps)] for maps in modes]
    # 17 products and every row of the table, once per addition
    assert sum(r[0] == MUL for r in ROWS) == 17
    assert sum(len(rows) for lanes, _ in pair
               for rows in lanes) == 2 * len(ROWS)


@pytest.mark.parametrize("G", [4, 8])
def test_schedule_replays_the_addition(points, G):
    """K2's program on ints equals vpin_tpu's limbs and e2_add_plain."""
    _, cases = points
    prog = build(G, [K2_ADD])
    for X, Y, want in cases:
        P, Q = port(X), port(Y)
        n = P.x.shape[0]
        fill = dict(enumerate(as_ints(P) + as_ints(Q)))
        for order in (1, -1):
            got = PointW(*from_ints(run(prog, n, fill, (0, 1, 2), order)))
            assert all(np.array_equal(convert.tensor_to_jax(g), np.asarray(w))
                       for g, w in zip(got, want))
            plain = cuda_ec.e2_add_plain(E2, tuple(P), tuple(Q))
            assert all(torch.equal(g, w) for g, w in zip(got, plain))


@pytest.mark.parametrize("G", [4, 8])
def test_schedule_replays_the_ladder_step(points, G):
    """K3's step programs on ints: both additions in one set of stages give
    acc + base and base + base as vpin_tpu does, and so does each alone."""
    jadd, cases = points
    for acc_j, base_j, _ in cases:
        acc, base = port(acc_j), port(base_j)
        n = acc.x.shape[0]
        fill = dict(zip(ACC + BASE, as_ints(acc) + as_ints(base)))
        want_add = port(jadd(acc_j, base_j))
        want_dbl = port(jadd(base_j, base_j))
        for maps, outs in (([K3_ADD, K3_DBL_PAIR], (want_add, want_dbl)),
                           ([K3_ADD], (want_add, base)),
                           ([K3_DBL], (acc, want_dbl))):
            got = run(build(G, maps), n, fill, ACC + BASE, order=-1)
            got_acc, got_base = PointW(*from_ints(got[:3])), PointW(
                *from_ints(got[3:]))
            for g, w in ((got_acc, outs[0]), (got_base, outs[1])):
                assert all(torch.equal(a, b) for a, b in zip(g, w))
