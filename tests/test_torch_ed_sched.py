"""The stage schedule of the K5 group kernel (vpin_tpu_torch/csrc/
ed_sched.cuh), as vpin_tpu_torch/curve/e2_sched.py lays it out for the
kernel, replayed on Python ints mod p = 2^255 - 19.

The kernel runs the program that e2_sched.build lays out: virtual lane v of
addition j on lane (v + j * width) % G, each lane's rows in table order, a
__syncwarp between stages, and 2d T2 formed once per mode.  This is the only
check of the kernel's data flow without a card: the replay must give
vpin_tpu's limbs (its jitted RistrettoGroup._add_jnp) and the port's plain
version, for one addition and for each mode of the ladder step, with 4 and 8
lanes; a whole ladder replayed step by step, as the kernel picks each step's
mode from the bits, must give ed_ladder_plain's limbs; and the packed
program must hold the rows the replay ran.

Tolerance: exact.  Every field operation returns the canonical residue, so
a schedule of the same polynomials gives the same limbs.
"""

import jax
import numpy as np
import pytest
import torch

from vpin_tpu.curve.ristretto import RISTRETTO as JR
from vpin_tpu_torch import convert
from vpin_tpu_torch.curve import cuda_edwards, e2_sched
from vpin_tpu_torch.curve.ristretto import RISTRETTO as R, PointE
from vpin_tpu_torch.curve.weierstrass import pack_bits
from vpin_tpu_torch.field.limbs import ints_to_limbs, limbs_to_ints, to_numpy

from test_torch_e2_sched import check_races
from test_torch_ristretto import _both, _edge_and_random_pairs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many ops on tiny tensors (see
    test_torch_curve.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HEADER = e2_sched.ED_HEADER
SLOTS, KINDS, ROWS, DEFINES = e2_sched.schedule(HEADER)
MUL, ADD, SUB = (KINDS.index(k) for k in ("E2_MUL", "E2_ADD", "E2_SUB"))
P = R.F.modulus
RINV = pow(1 << 256, -1, P)
NEITHER, K5_ADD, K5_DBL, K5_BOTH = e2_sched.modes("ed_ladder")
ADD_ONLY, = K5_ADD
DBL_ONLY, = K5_DBL
ACC, BASE = ADD_ONLY["out"], DBL_ONLY["out"]
NSLOTS = DEFINES["ED_EL_TEMP"] + 2 * e2_sched.temps(HEADER)
D2 = int(limbs_to_ints(to_numpy(R.const("d2", "cpu"))[None])[0])
# one addition P + Q into a third point, on the kernel's element slots
ONE = e2_sched.ed_layout(ACC + BASE, tuple(range(NSLOTS, NSLOTS + 4)),
                         DEFINES["ED_EL_TEMP"])


def build(G, maps):
    return e2_sched.build(G, maps, HEADER)


def unpack(blob, G, nmodes):
    """The EdProg bytes as csrc/e2.cuh's GroupProg lays them out with
    ed_sched.cuh's sizes: per mode and stage, (each lane's rows, rounds)."""
    nops = DEFINES["ED_MAXOPS"] + 1
    shape = (DEFINES["ED_MODES"], DEFINES["ED_NSTAGE"],
             e2_sched.schedule()[3]["E2_MAXG"] + 1)
    op = np.frombuffer(blob[:4 * nops].tobytes(), "<u4")
    at = 4 * nops + 2 * int(np.prod(shape))
    start = np.frombuffer(blob[4 * nops:at].tobytes(), "<u2").reshape(shape)
    rounds = blob[at:at + shape[0] * shape[1]].reshape(shape[:2])
    assert len(blob) == -(-(at + shape[0] * shape[1]) // 16) * 16
    return [[([[(int(w) & 0xff, int(w) >> 8 & 0xff, int(w) >> 16 & 0xff,
                 int(w) >> 24) for w in op[start[m, s, l]:start[m, s, l + 1]]]
               for l in range(G)], int(rounds[m, s]))
             for s in range(shape[1])] for m in range(nmodes)]


def check_order(prog):
    """A row reads only values of earlier stages or of its own lane's
    earlier rows: a slot another lane writes in the stage is never read
    (check_races), and a slot that its own lane writes in the stage is read
    only after the lane has written it."""
    for s, (lanes, _) in enumerate(prog):
        for rows in lanes:
            written = set()
            later = {r[1] for r in rows}
            for kind, d, a, b in rows:
                for x in (a, b):
                    assert x in written or x not in later, (s, x)
                written.add(d)


def replay(prog, slots, order=1):
    """Run the program on ints in Montgomery form, each stage's lanes in
    ``order``; each lane runs its product rounds, one product a round."""
    for lanes, rounds in prog:
        for rows in lanes[::order]:
            assert sum(r[0] == MUL for r in rows) <= rounds
            for kind, d, a, b in rows:
                x, y = slots[a], slots[b]
                slots[d] = (x * y * RINV if kind == MUL else
                            x + y if kind == ADD else x - y) % P
    return slots


def element(acc, base, i):
    """The kernel's element slots for point i: acc, base and 2d."""
    slots = [0] * (NSLOTS + 4)
    slots[DEFINES["ED_EL_D2"]] = D2
    for k, c in zip(ACC + BASE, acc + base):
        slots[k] = int(c[i])
    return slots


def as_ints(Pt):
    return [limbs_to_ints(to_numpy(c)) for c in Pt]


def from_ints(cols):
    return PointE(*(torch.from_numpy(ints_to_limbs(
        [int(v) for v in c]).astype(np.int32)) for c in cols))


def run(prog, acc, base, out, order=1):
    """Replay ``prog`` on every element of the int columns acc and base;
    returns the out slots' int columns."""
    res = [[] for _ in out]
    for i in range(len(acc[0])):
        slots = replay(prog, element(acc, base, i), order)
        for r, k in zip(res, out):
            r.append(slots[k])
    return res


@pytest.fixture(scope="module")
def points():
    """The edge pairs of test_torch_ristretto.py and random ones, then
    projective sums (vpin_tpu's, Z != 1): (P, Q), (P + Q, Q), (P + Q,
    P + 2Q) and (P + 2Q, P + 2Q), each with vpin_tpu's sum."""
    jadd = jax.jit(JR._add_jnp)
    lhs, rhs = _edge_and_random_pairs(6, 11)
    (_, JP), (_, JQ) = _both(lhs), _both(rhs)
    S1 = jadd(JP, JQ)
    S2 = jadd(S1, JQ)
    pairs = [(JP, JQ), (S1, JQ), (S1, S2), (S2, S2)]
    return jadd, [(X, Y, jadd(X, Y)) for X, Y in pairs]


def port(JP):
    return convert.pointe_from_jax(JP, "cpu")


def equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("G", [4, 8])
def test_schedule_rounds_and_races(G):
    """One addition and each single mode wait on 1 + 1 + 1 product rounds;
    the ladder step's pair on 1 + 1 + 1 with 8 lanes and 2 + 1 + 2 with 4,
    its 17 products (2d T2 once); no stage races between lanes, and the
    packed program holds the rows the replay runs."""
    assert [r for _, r in build(G, [ONE])] == [1, 1, 1]
    assert [r for _, r in build(G, K5_ADD)] == [1, 1, 1]
    assert [r for _, r in build(G, K5_DBL)] == [1, 1, 1]
    pair = build(G, K5_BOTH)
    assert [r for _, r in pair] == {8: [1, 1, 1], 4: [2, 1, 2]}[G]
    assert build(G, NEITHER) == [([[] for _ in range(G)], 0)] * 3
    for prog in (build(G, [ONE]), pair, build(G, K5_ADD), build(G, K5_DBL)):
        check_races(prog)
        check_order(prog)
    # 9 products and every row of the table, once per addition but 2d T2
    assert sum(r[0] == MUL for r in ROWS) == 9
    assert sum(r[0] == MUL for lanes, _ in pair for rows in lanes
               for r in rows) == 17
    assert sum(len(rows) for lanes, _ in pair
               for rows in lanes) == 2 * len(ROWS) - 1
    modes = e2_sched.modes("ed_ladder")
    blob = e2_sched.pack(G, modes, HEADER)
    assert unpack(blob, G, len(modes)) == [
        [(lanes, r) for lanes, r in build(G, maps)] for maps in modes]
    assert torch.equal(e2_sched.program("ed_ladder", G, "cpu"),
                       torch.from_numpy(blob.copy()))


@pytest.mark.parametrize("G", [4, 8])
def test_schedule_replays_the_addition(points, G):
    """One addition on ints equals vpin_tpu's limbs and ed_add_plain, each
    stage's lanes run in either order."""
    _, cases = points
    prog = build(G, [ONE])
    out = tuple(range(NSLOTS, NSLOTS + 4))
    for X, Y, want in cases:
        acc, base = as_ints(port(X)), as_ints(port(Y))
        plain = cuda_edwards.ed_add_plain(R, tuple(port(X)), tuple(port(Y)))
        for order in (1, -1):
            got = from_ints(run(prog, acc, base, out, order))
            assert all(np.array_equal(convert.tensor_to_jax(g), np.asarray(w))
                       for g, w in zip(got, want))
            assert equal(got, plain)


@pytest.mark.parametrize("G", [4, 8])
def test_schedule_replays_the_ladder_step(points, G):
    """Each mode of K5's step on ints: acc + base and base + base in one set
    of stages give vpin_tpu's sums, and so does each alone; neither leaves
    both points as they were."""
    jadd, cases = points
    for acc_j, base_j, _ in cases:
        acc, base = port(acc_j), port(base_j)
        want_add = port(jadd(acc_j, base_j))
        want_dbl = port(jadd(base_j, base_j))
        for maps, outs in ((K5_BOTH, (want_add, want_dbl)),
                           (K5_ADD, (want_add, base)),
                           (K5_DBL, (acc, want_dbl)),
                           (NEITHER, (acc, base))):
            got = run(build(G, maps), as_ints(acc), as_ints(base),
                      ACC + BASE, order=-1)
            assert equal(from_ints(got[:4]), outs[0])
            assert equal(from_ints(got[4:]), outs[1])


@pytest.mark.parametrize("G", [4, 8])
def test_schedule_replays_a_ladder(G):
    """The kernel's loop on ints: acc from the identity (0 : R : R : 0),
    each step's mode from its bit (ADD where it is set, DBL but on the last
    bit), over 12 bits with the zero scalar, all ones and the scalar 1
    among the rows, equals ed_ladder_plain's limbs; and the wrapper, on the
    CPU the plain version, takes only the lane counts the kernel offers."""
    lhs, _ = _edge_and_random_pairs(2, 12)
    Pp, _ = _both(lhs)
    n, n_bits = Pp.x.shape[0], 12
    rows = np.random.RandomState(12).randint(0, 2, size=(n, n_bits))
    rows[0], rows[1], rows[2] = 0, 1, 0
    rows[2, 0] = 1
    words = torch.from_numpy(pack_bits(rows.astype(np.uint32)).view(np.int32))
    want = cuda_edwards.ed_ladder_plain(R, tuple(Pp), words, n_bits, 1, n)
    progs = [build(G, maps) for maps in e2_sched.modes("ed_ladder")]
    one = int(limbs_to_ints(to_numpy(R.F.ones((), "cpu"))[None])[0])
    base = as_ints(Pp)
    acc = [[0] * n, [one] * n, [one] * n, [0] * n]
    res = [[] for _ in range(4)]
    for i in range(n):
        slots = element(acc, base, i)
        for k in range(n_bits):
            mode = (DEFINES["K5_MODE_ADD"] if rows[i, k] else 0) | (
                DEFINES["K5_MODE_DBL"] if k + 1 < n_bits else 0)
            slots = replay(progs[mode], slots)
        for r, s in zip(res, ACC):
            r.append(slots[s])
    assert equal(from_ints(res), want)
    assert equal(cuda_edwards.ed_ladder(R, tuple(Pp), words, n_bits, 1, n,
                                        _lanes=G), want)
    for bad in (0, 2, 16):
        with pytest.raises(ValueError):
            cuda_edwards.ed_ladder(R, tuple(Pp), words, n_bits, 1, n,
                                   _lanes=bad)


def test_ed_ladder_lanes_at_their_crossovers():
    """K5's choice of lanes by batch size, at the crossovers measured on the
    H100 (PERF.md): 8 lanes a ladder below 8,192 ladders, 4 below 16,384,
    one thread a ladder from there; every choice is a lane count the kernel
    offers, and each group lane count has a program."""
    assert [cuda_edwards.ed_ladder_lanes(n) for n in (
        1, 8, 1024, 4096, 8191, 8192, 16383, 16384, 1 << 15)] \
        == [8, 8, 8, 8, 8, 4, 4, 1, 1]
    assert cuda_edwards.LADDER_LANES == (1, 4, 8)
    for g in cuda_edwards.LADDER_LANES[1:]:
        assert e2_sched.program("ed_ladder", g, "cpu").numel() % 16 == 0
