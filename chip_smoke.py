#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vpin_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases:
  1. the card's name and power limit (nvidia-smi);
  2. build the five CUDA kernels from vpin_tpu_torch/csrc, all at once, and
     print their registers and spills;
  3. hold each kernel bit for bit against its plain PyTorch version on the
     card, at the main path's shapes plus edge and special cases (K4 up to
     the 1,024 x 2,048 pairs of the SPARK comb_ops fold), and time both
     (CUDA events, after warm-up).  K5, the ristretto ladder, is off the
     main path: its own path (RistrettoGroup.msm_bits at tests/test_msm.py's
     8 x 253 bits and at 4,096 x 253) runs here with the launch counts set
     to 0 before it, and its sums must equal the K4 table MSM and, at 8
     points, host_ristretto;
  4. replay the four golden fixtures of crosscheck/gen_golden.py (2 adds,
     2 mults; transparent and with the SPARK eval proof) with the witness
     and every table on the CUDA route (every crossover lowered to 0): both
     challenge streams and the proof bytes must equal crosscheck/golden/,
     which vpin_tpu produced;
  5. the main path at full width: four encrypted conv3/32x32 requests
     through run_conv_workload, then the CP-SNARK proofs of one warm
     request's trace (16 adds, 18 mults), transparent and with the eval
     proof, verified on the host.  Each request has its rLC check, 18/16
     trace counts, points on E2, 8 output pixels per half and the whole
     witness trace held exactly against the host's curve arithmetic
     (curve/host_ec.py); the proofs must verify and have the sizes their
     instances' shapes give, and K1 and K4 must run inside the mult proof's
     SPARK spans (SNARK::encode, R1CSEvalProof::prove);
  6. each kernel's launch count on the main path (K5's on its own path).
The line before the last is a JSON object with every kernel's numbers; the
last is {"ok": true, "device": {...}}.  Any failure raises: the script then
exits non-zero without that line.  Without a GPU it exits 1 at once.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM: 32-bit integer multiply and multiply-add, 64 results per clock
# per SM (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions, compute capability 9.0); memory 3.35 TB/s (NVIDIA data sheet).
MUL32_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
# one CIOS Montgomery product over 8 x 32-bit limbs: 64 limb products for
# a*b and 64 for m*N, each a lo and a hi multiply, plus 8 for m
MUL32_PER_MONT = 2 * 64 + 2 * 64 + 8
# the same product modulo p = 2^255 - 19 needs less: each of the 8 rounds
# takes m*p as m*2^255 - 19*m, a lo and a hi multiply by 19
MUL32_PER_MONT_P = 2 * 64 + 8 + 2 * 8
MONT_PER_E2_ADD = 17
MONT_PER_ED_ADD = 9
# K5's shapes: tests/test_msm.py's ladder MSM, and a batch that fills part
# of the card
LADDER_SHAPES = ((8, 253), (4096, 253))
# K4's largest batch on the main path: the first fold of the SPARK comb_ops
# commitment of the 18-mult proof (2^21 entries in 1,024 Hyrax rows, summed
# through a digit table 4,096 wide), 1,024 rows x 2,048 pairs
FOLD_SHAPE = (1024, 2048)
FILTER = 3
SIZE = 32
REQUESTS = 4
PROOF_TAPE_SEED = 3
# transparent proof sizes of the conv3/32x32 trace: they depend only on the
# instances' shapes (BENCH_r05.json: 19,920 B for the 18 mults; the 16-add
# proof measured with vpin_tpu on the CPU).  The full SNARK adds the eval
# proof, whose size eval_proof_bytes derives from the shapes (BENCH_r05.json:
# 27,240 B for the 16 adds).
ADD_PROOF_BYTES = 6992
MULT_PROOF_BYTES = 19920
ADD_FULL_PROOF_BYTES = 27240


class SmokeError(Exception):
    pass


def require(ok, what: str) -> None:
    if not ok:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

def kernel_ms(torch, fn, launches: int = 20, repeats: int = 5) -> float:
    """Median device time of one call of ``fn``: ``launches`` calls are
    queued behind a sleep kernel, so the host's enqueue time stays out of
    the events' window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def wall_ms(torch, fn, repeats: int = 1) -> float:
    """Median host time of ``fn`` ending in a device synchronize (the plain
    versions: thousands of small launches and some host syncs)."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def bound_ms(mul32: float, nbytes: float, mul32_rate: float):
    t_ops = mul32 / mul32_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def next_pow2(n: int) -> int:
    m = 1
    while m < max(n, 1):
        m *= 2
    return m


def eval_proof_bytes(num_cons: int, num_vars: int, nnz: int,
                     batch: int = 3) -> int:
    """Bincode bytes of the SPARK eval proof of an R1CS instance with these
    counts (one input): Hyrax rows of the derefs, the product layer (two
    batched product-circuit proofs) and the hash layer (three
    PolyEvalProofs).  It gives the golden fixtures' 12,208 and 46,416 B."""
    log2 = lambda n: n.bit_length() - 1                       # noqa: E731
    vec = lambda k: 8 + 32 * k                                # noqa: E731
    cons, nv = next_pow2(max(num_cons, 2)), next_pow2(max(num_vars, 2))
    cells = 1 << max(log2(cons), log2(2 * nv))
    N = next_pow2(nnz)

    def polyeval(nvars):                      # bullet L, R; delta, beta, z1, z2
        return 2 * vec(nvars - nvars // 2) + 4 * 32

    def product_proof(K, leaves, k2):          # layer i has i cubic rounds
        return 8 + sum(8 + i * vec(3) + 2 * vec(K)
                       for i in range(log2(leaves))) + 3 * vec(k2)

    ops_vars = log2(N) + log2(next_pow2(5 * batch))
    mem_vars = log2(cells) + 1
    derefs_vars = log2(N) + log2(next_pow2(2 * batch))
    product_layer = (2 * (2 * 32 + 2 * vec(batch)) + 2 * vec(batch)
                     + product_proof(4, cells, 0)
                     + product_proof(4 * batch, N, 2 * batch))
    hash_layer = (2 * (2 * vec(batch) + 32) + 3 * vec(batch)
                  + polyeval(ops_vars) + polyeval(mem_vars)
                  + polyeval(derefs_vars))
    return vec(1 << (derefs_vars // 2)) + product_layer + hash_layer


def max_abs_err(torch, got, want) -> int:
    return max(int((g.long() - w.long()).abs().max().item()) if g.numel() else 0
               for g, w in zip(got, want))


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------

def field_operands(torch, F, n: int, seed: int, dev):
    """n canonical elements: edge values first, then uniform limbs below N."""
    from vpin_tpu_torch.field.limbs import ints_to_limbs, to_tensor
    N = F.modulus
    top = N >> 224
    edges = [0, 1, 2, N - 1, N - 2, (N - 1) // 2, 2**128,
             ((top - 1) << 224) | (2**224 - 1), N - 2**32]
    edges += [(1 << k) - 1 for k in range(16, F.num_bits, 16)]
    rs = np.random.RandomState(seed)
    limbs = rs.randint(0, 2**32, size=(n, 8), dtype=np.uint64)
    limbs[:, 7] %= top                        # value < top * 2^224 <= N
    limbs = limbs.astype(np.uint32)
    limbs[:len(edges)] = ints_to_limbs(edges)
    return to_tensor(limbs, dev)


def check_mont_mul(torch, dev, rate):
    from vpin_tpu_torch.field import FP, FQ
    from vpin_tpu_torch.field.cuda_mont import mont_mul, mont_mul_plain
    from vpin_tpu_torch.field.limbs import limbs_to_ints, to_numpy
    n = 1 << 16
    rows = {}
    for F, seed in ((FQ, 1), (FP, 2)):
        a = field_operands(torch, F, n, seed, dev)
        b = field_operands(torch, F, n, seed + 10, dev)
        b = torch.flip(b, [0]).contiguous()    # edges meet random and edges
        got = mont_mul(a, b, F)
        want = mont_mul_plain(a, b, F)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"mont_mul {F.name}: kernel != plain")
        # and exact on the host for the edges
        Rinv = pow(1 << 256, -1, F.modulus)
        xs = limbs_to_ints(to_numpy(a[:64]))
        ys = limbs_to_ints(to_numpy(b[:64]))
        gs = limbs_to_ints(to_numpy(got[:64]))
        require(all(int(g) == int(x) * int(y) * Rinv % F.modulus
                    for g, x, y in zip(gs, xs, ys)),
                f"mont_mul {F.name}: kernel != exact host product")
        ms = kernel_ms(torch, lambda: mont_mul(a, b, F), launches=200)
        plain = wall_ms(torch, lambda: mont_mul_plain(a, b, F), repeats=5)
        per = MUL32_PER_MONT_P if F is FP else MUL32_PER_MONT
        bnd, by = bound_ms(per * n, 96 * n, rate)
        log(f"K1 mont_mul {F.name} n={n}: bit-equal to plain; "
            f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bnd:.4f} ms "
            f"({by})")
        rows[F.name] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                            max_abs_err=max_abs_err(torch, [got], [want]))
    return rows["Fl"]


def random_points(torch, dev, n: int, seed: int):
    """n projective points of E2 on the device: the seven special sums of
    tests/test_curve_e2.py first, then random multiples of G, each scaled
    by a random Z (so no two share a representation)."""
    from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER, host_infinity
    from vpin_tpu_torch.curve.weierstrass import E2, PointW
    G, INF = E2_G_HOST, host_infinity()
    rng = random.Random(seed)
    P_sp = [G, G, INF, INF, G, 2 * G, 3 * G]
    Q_sp = [G, INF, G, INF, -G, 2 * G, -3 * G]
    pool = [rng.randrange(1, E2_ORDER) * G for _ in range(256)]
    idx = np.random.RandomState(seed).randint(0, 256, size=n - 7)
    P = E2.from_affine_host(P_sp + [pool[i] for i in idx], dev)
    Q = E2.from_affine_host(Q_sp + [pool[i] for i in idx[::-1]], dev)
    F = E2.F

    def scale(R, s):
        Z = field_operands(torch, F, n, s, dev)
        Z[0] = F.ones((), dev)                 # keep one affine pair
        Z[Z.eq(0).all(-1)] = F.ones((), dev)
        return PointW(F.mul(R.x, Z), F.mul(R.y, Z), F.mul(R.z, Z))

    return scale(P, seed + 1), scale(Q, seed + 2)


def check_e2_add(torch, dev, rate):
    from vpin_tpu_torch.curve import cuda_ec
    from vpin_tpu_torch.curve.weierstrass import E2, take
    n = 1 << 16
    P, Q = random_points(torch, dev, n, 3)
    got = cuda_ec.e2_add(E2, tuple(P), tuple(Q))
    want = cuda_ec.e2_add_plain(E2, tuple(P), tuple(Q))
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "e2_add: kernel != plain")
    # and exact on the host for the special cases and a few more
    k = 32
    hp = E2.to_affine_host(take(P, slice(0, k)))
    hq = E2.to_affine_host(take(Q, slice(0, k)))
    from vpin_tpu_torch.curve.weierstrass import PointW
    hr = E2.to_affine_host(PointW(*(c[:k] for c in got)))
    require(all(hr[i] == hp[i] + hq[i] for i in range(k)),
            "e2_add: kernel != host_ec")
    ms = kernel_ms(torch, lambda: cuda_ec.e2_add(E2, tuple(P), tuple(Q)),
                   launches=50)
    plain = wall_ms(torch, lambda: cuda_ec.e2_add_plain(E2, tuple(P), tuple(Q)),
                    repeats=3)
    bnd, by = bound_ms(MONT_PER_E2_ADD * MUL32_PER_MONT * n, 288 * n, rate)
    log(f"K2 e2_add n={n}: bit-equal to plain and host_ec; kernel {ms:.4f} ms, "
        f"plain {plain:.3f} ms, bound {bnd:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                max_abs_err=max_abs_err(torch, got, want)), P


def ladder_adds(rows: np.ndarray, n: int, inner: int, nrows: int,
                n_bits: int) -> int:
    """Complete additions the ladder does for these bits: one per set bit
    and one doubling per bit but the last."""
    per_row = rows[:, :n_bits].sum(axis=1).astype(np.int64)
    pick = (np.arange(n) // inner) % nrows
    return int(per_row[pick].sum()) + n * max(n_bits - 1, 0)


def check_ladder(torch, dev, rate, P, n, n_bits, inner, nrows, label,
                 plain_repeats=1):
    from vpin_tpu_torch.curve import cuda_ec
    from vpin_tpu_torch.curve.host_ec import host_infinity
    from vpin_tpu_torch.curve.weierstrass import E2, PointW, pack_bits
    from vpin_tpu_torch.field.limbs import to_tensor
    rs = np.random.RandomState(n_bits + nrows)
    rows = rs.randint(0, 2, size=(nrows, n_bits)).astype(np.uint8)
    if nrows >= 3:
        rows[0] = 0                            # ladder of the zero scalar
        rows[1] = 1                            # all bits set
        rows[2] = 0
        rows[2, 0] = 1                         # the scalar 1
    words = to_tensor(pack_bits(rows), dev)
    base = tuple(c[:n].clone() for c in P)
    base[0][7] = 0                             # a ladder on the identity
    base[1][7] = E2.F.ones((), dev)
    base[2][7] = 0
    got = cuda_ec.e2_scalar_mul(E2, base, words, n_bits, inner, nrows)
    t = time.perf_counter()
    want = cuda_ec.e2_scalar_mul_plain(E2, base, words, n_bits, inner, nrows)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t) * 1e3
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            f"e2_scalar_mul {label}: kernel != plain")
    k = 16
    hb = E2.to_affine_host(PointW(*(c[:k] for c in base)))
    hr = E2.to_affine_host(PointW(*(c[:k] for c in got)))
    for i in range(k):
        r = rows[(i // inner) % nrows]
        s = int("".join(str(int(v)) for v in r[::-1]), 2) if n_bits else 0
        want_i = s * hb[i] if s else host_infinity()
        require(hr[i] == want_i, f"e2_scalar_mul {label}: element {i} != host_ec")
    if plain_repeats > 1:
        plain = wall_ms(torch, lambda: cuda_ec.e2_scalar_mul_plain(
            E2, base, words, n_bits, inner, nrows), repeats=plain_repeats)
    ms = kernel_ms(torch, lambda: cuda_ec.e2_scalar_mul(
        E2, base, words, n_bits, inner, nrows), launches=3, repeats=3)
    adds = ladder_adds(rows, n, inner, nrows, n_bits)
    bnd, by = bound_ms(MONT_PER_E2_ADD * MUL32_PER_MONT * adds,
                       192 * n + words.numel() * 4, rate)
    log(f"K3 e2_scalar_mul {label} ({n} x {n_bits} bits, inner={inner}, "
        f"rows={nrows}, {adds} complete adds): bit-equal to plain and "
        f"host_ec; kernel {ms:.4f} ms, plain {plain:.1f} ms, bound {bnd:.4f} "
        f"ms ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                max_abs_err=max_abs_err(torch, got, want))


def edwards_points(torch, dev, n: int, seed: int):
    """Two batches of n ristretto points on the device: identity + P, P + P,
    P + (-P), identity + identity and two from_uniform_bytes points first,
    then random multiples of the basepoint, every point scaled by a random
    lambda in (lX : lY : lZ : lT) so no two share a representation."""
    from vpin_tpu_torch.curve import host_ristretto as H
    from vpin_tpu_torch.curve.ristretto import RISTRETTO as R, PointE
    from vpin_tpu_torch.curve.rpoint import pointe_from_host
    from vpin_tpu_torch.field import FP
    rng = random.Random(seed)
    pool = [H.basepoint().mul(rng.randrange(1, 2**252)) for _ in range(64)]
    P0, ID = pool[0], H.identity()
    idx = np.random.RandomState(seed).randint(0, 64, size=n - 4)
    lhs = [ID, P0, P0, ID] + [pool[i] for i in idx]
    rhs = [P0, P0, -P0, ID] + [pool[i] for i in idx[::-1]]
    P = pointe_from_host(lhs, dev)
    Q = pointe_from_host(rhs, dev)
    chunks = [bytes([seed, i]) * 32 for i in range(4)]
    U = R.from_uniform_bytes(chunks, dev)
    P = PointE(*(torch.cat([c[:4], u[:2], c[6:]]) for c, u in zip(P, U)))
    Q = PointE(*(torch.cat([c[:4], u[2:], c[6:]]) for c, u in zip(Q, U)))

    def scale(X, s):
        lam = field_operands(torch, FP, n, s, dev)
        lam[:8] = FP.ones((), dev)             # keep the edge cases as made
        lam[lam.eq(0).all(-1)] = FP.ones((), dev)
        return PointE(*(FP.mul(c, lam) for c in X))

    return scale(P, seed + 1), scale(Q, seed + 2)


def check_ed_add(torch, dev, rate):
    from vpin_tpu_torch.curve import cuda_edwards, host_ristretto as H
    from vpin_tpu_torch.curve.ristretto import RISTRETTO as R, PointE
    n = 1 << 16
    P2, Q2 = edwards_points(torch, dev, 2 * n, 5)
    P, Q = (PointE(*(c[:n] for c in X)) for X in (P2, Q2))
    got = cuda_edwards.ed_add(R, tuple(P), tuple(Q))
    want = cuda_edwards.ed_add_plain(R, tuple(P), tuple(Q))
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)),
            "ed_add: kernel != plain")
    err = max_abs_err(torch, got, want)
    # and exact on the host for the edge cases and a few more
    k = 24
    hp = [H.decode(e) for e in R.encode_bytes(PointE(*(c[:k] for c in P)))]
    hq = [H.decode(e) for e in R.encode_bytes(PointE(*(c[:k] for c in Q)))]
    enc = R.encode_bytes(PointE(*(c[:k] for c in got)))
    require(enc == [(a + b).encode() for a, b in zip(hp, hq)],
            "ed_add: kernel != host_ristretto")
    require(enc[2] == bytes(32) and enc[3] == bytes(32),
            "ed_add: P + (-P) or identity + identity is not the identity")
    # the Hyrax fold shape: 256 rows x 512 columns
    F, G = (PointE(*(c.reshape(256, 512, 8) for c in X)) for X in (P2, Q2))
    got2 = cuda_edwards.ed_add(R, tuple(F), tuple(G))
    want2 = cuda_edwards.ed_add_plain(R, tuple(F), tuple(G))
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got2, want2)),
            "ed_add 256x512: kernel != plain")
    err = max(err, max_abs_err(torch, got2, want2))
    del got2, want2

    def timed(A, B, m, launches, repeats):
        ms = kernel_ms(torch, lambda: cuda_edwards.ed_add(R, tuple(A),
                                                          tuple(B)),
                       launches=launches)
        plain = wall_ms(torch, lambda: cuda_edwards.ed_add_plain(
            R, tuple(A), tuple(B)), repeats=repeats)
        bnd, by = bound_ms(MONT_PER_ED_ADD * MUL32_PER_MONT_P * m, 384 * m,
                           rate)
        return dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)

    row = timed(P, Q, n, 100, 3)
    log(f"K4 ed_add n={n}: bit-equal to plain (and at 256x512) and to "
        f"host_ristretto; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    A, B = fold_points(torch, dev, (P2, Q2), FOLD_SHAPE)
    got3 = cuda_edwards.ed_add(R, tuple(A), tuple(B))
    want3 = cuda_edwards.ed_add_plain(R, tuple(A), tuple(B))
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got3, want3)),
            f"ed_add {FOLD_SHAPE}: kernel != plain")
    err = max(err, max_abs_err(torch, got3, want3))
    del got3, want3
    fold = timed(A, B, int(np.prod(FOLD_SHAPE)), 20, 1)
    log(f"K4 ed_add {FOLD_SHAPE[0]} x {FOLD_SHAPE[1]} pairs (the SPARK "
        f"comb_ops fold): bit-equal to plain; kernel {fold['ms']:.4f} ms, "
        f"plain {fold['plain_ms']:.3f} ms, bound {fold['bound_ms']:.4f} ms "
        f"({fold['bound_by']})")
    row["max_abs_err"] = err
    return row


def fold_points(torch, dev, pairs, shape):
    """The pairs tiled out to ``shape``, every point scaled by a random
    nonzero lambda so no two share a representation."""
    from vpin_tpu_torch.curve.ristretto import PointE
    from vpin_tpu_torch.field import FP
    m = int(np.prod(shape))
    out = []
    for X, seed in zip(pairs, (31, 32)):
        reps = m // X.batch_shape[0]
        lam = field_operands(torch, FP, m, seed, dev)
        lam[lam.eq(0).all(-1)] = FP.ones((), dev)
        out.append(PointE(*(FP.mul(c.repeat(reps, 1), lam).reshape(
            shape + (8,)) for c in X)))
    return tuple(out)


def check_ed_ladder(torch, dev, rate):
    """K5: its path (msm_bits) with the counts from 0, the sums against the
    K4 table MSM and host_ristretto, then the kernel against its plain
    version at each shape.  Returns ({n: row}, launches on its path)."""
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.curve import cuda_edwards, host_ristretto as H
    from vpin_tpu_torch.curve.msm import host_digits, msm_oneshot
    from vpin_tpu_torch.curve.ristretto import RISTRETTO as R, PointE
    from vpin_tpu_torch.curve.weierstrass import pack_bits
    from vpin_tpu_torch.field.limbs import to_tensor
    from vpin_tpu_torch.field.prime_field import L_MODULUS
    cases = []
    for n, n_bits in LADDER_SHAPES:
        P, _ = edwards_points(torch, dev, max(n, 64), 20 + n % 7)
        P = PointE(*(c[:n] for c in P))
        rows = np.random.RandomState(n).randint(0, 2, size=(n, n_bits)
                                                ).astype(np.uint8)
        rows[1] = 0                            # the zero scalar
        rows[2] = 1                            # all bits set
        rows[4] = 0
        rows[4, 0] = 1                         # the scalar 1
        ks = [int.from_bytes(np.packbits(r, bitorder="little").tobytes(),
                             "little") % L_MODULUS for r in rows]
        cases.append((n, n_bits, P, rows, ks))

    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    sums = [R.msm_bits(P, rows) for _, _, P, rows, _ in cases]
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["ed_ladder"]
    require(launches == len(cases), f"K5 path: {launches} ed_ladder launches")

    out = {}
    for (n, n_bits, P, rows, ks), total in zip(cases, sums):
        enc = R.encode_bytes(total)
        table = msm_oneshot(R, P, torch.as_tensor(host_digits(ks), device=dev))
        require(enc == R.encode_bytes(table),
                f"msm_bits {n}: != the K4 table MSM")
        hp = [H.decode(e) for e in R.encode_bytes(PointE(*(c[:8] for c in P)))]
        if n == 8:
            require(enc == [H.msm(ks, hp).encode()],
                    "msm_bits 8: != host_ristretto")
        words = to_tensor(pack_bits(rows), dev)
        got = cuda_edwards.ed_ladder(R, tuple(P), words, n_bits, 1, n)
        t = time.perf_counter()
        want = cuda_edwards.ed_ladder_plain(R, tuple(P), words, n_bits, 1, n)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t) * 1e3
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"ed_ladder {n} x {n_bits}: kernel != plain")
        head = R.encode_bytes(PointE(*(c[:8] for c in got)))
        require(head == [p.mul(k).encode() for p, k in zip(hp, ks)],
                f"ed_ladder {n} x {n_bits}: kernel != host_ristretto")
        ms = kernel_ms(torch, lambda: cuda_edwards.ed_ladder(
            R, tuple(P), words, n_bits, 1, n), launches=3, repeats=3)
        # the additions these bits need: one per set bit, one doubling per
        # bit but the last
        adds = int(rows.sum()) + n * (n_bits - 1)
        bnd, by = bound_ms(adds * MONT_PER_ED_ADD * MUL32_PER_MONT_P,
                           256 * n + words.numel() * 4, rate)
        log(f"K5 ed_ladder {n} x {n_bits} bits ({adds} additions): bit-equal "
            f"to plain and host_ristretto, msm_bits == table MSM; kernel "
            f"{ms:.4f} ms, plain {plain:.1f} ms, bound {bnd:.4f} ms ({by})")
        out[n] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                      max_abs_err=max_abs_err(torch, got, want))
    return out, launches


# ----------------------------------------------------------------------
# phase 4: golden fixtures on the CUDA route
# ----------------------------------------------------------------------

def golden_fixture(kind: str, dev):
    """The gadget of crosscheck/gen_golden.py's fixture, built with the
    port's own host_ec and gadgets."""
    from vpin_tpu_torch.curve.host_ec import E2_G_HOST, E2_ORDER
    from vpin_tpu_torch.gadgets import point_addition_gadget, point_mult_gadget
    if kind == "add":
        rng = random.Random(2024)
        px, py, rx, ry, rz = [], [], [], [], []
        for t in range(2):
            P = rng.randrange(1, E2_ORDER) * E2_G_HOST
            if t == 1:
                rz.append(1)
                rx.append(0)
                ry.append(0)
            else:
                Rp = rng.randrange(1, E2_ORDER) * E2_G_HOST
                rz.append(0)
                rx.append(Rp.x)
                ry.append(Rp.y)
            px.append(P.x)
            py.append(P.y)
        return point_addition_gadget(px, py, rx, ry, rz, device=dev)
    rng = random.Random(2025)
    ws, px, py = [], [], []
    for _ in range(2):
        ws.append(rng.randrange(1, 1 << 128))
        P = rng.randrange(1, E2_ORDER) * E2_G_HOST
        px.append(P.x)
        py.append(P.y)
    return point_mult_gadget(ws, px, py, n=128, device=dev)


def replay_golden(torch, dev):
    """The four golden fixtures with the witness and every table on the
    tensor route (HOST_POLY_MAX and DEVICE_WITNESS_THRESHOLD = 0), held byte
    for byte against crosscheck/golden/."""
    from pathlib import Path
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.gadgets import point_addition, point_mult
    from vpin_tpu_torch.poly import dense
    from vpin_tpu_torch.snark import (
        SNARKGens, cp_commit_witness, cp_snark_prove, cp_snark_verify,
        snark_encode,
    )
    from vpin_tpu_torch.transcript import Transcript
    from vpin_tpu_torch.utils.bincode import serialize_snark
    golden_dir = Path(__file__).resolve().parent / "crosscheck" / "golden"
    crossovers = [(dense, "HOST_POLY_MAX"),
                  (point_addition, "DEVICE_WITNESS_THRESHOLD"),
                  (point_mult, "DEVICE_WITNESS_THRESHOLD")]
    saved = [getattr(m, name) for m, name in crossovers]
    for m, name in crossovers:
        setattr(m, name, 0)
    try:
        for kind in ("add", "mult"):
            t = time.perf_counter()
            gadget = golden_fixture(kind, dev)
            t_gadget = time.perf_counter() - t
            inst, vp, vi, vf, inputs, nc, nv, ni, nnz = gadget
            require(isinstance(vf, torch.Tensor) and vf.is_cuda,
                    f"golden {kind}: witness not a CUDA tensor")
            for full in (False, True):
                fname = (f"point_{kind}_cp_full_snark_challenges.json" if full
                         else f"point_{kind}_cp_challenges.json")
                golden = json.loads((golden_dir / fname).read_text())
                before = dict(kernels.LAUNCHES)
                t = time.perf_counter()
                gens = SNARKGens(nc, nv, ni, nnz)
                comm = decomm = None
                if full:
                    comm, decomm = snark_encode(inst, gens)
                pv, cv, bv, cpc, cic = cp_commit_witness(
                    vp, vi, vf, gens, tape_seed=11, device=dev)
                require(not pv.is_host, f"golden {fname}: witness poly on "
                        "the host")
                plog, vlog = [], []
                proof = cp_snark_prove(inst, vf, inputs, gens,
                                       Transcript(b"snark_example", log=plog),
                                       pv, cv, bv, decomm=decomm,
                                       tape_seed=11, with_eval_proof=full)
                torch.cuda.synchronize()
                t_prove = time.perf_counter() - t
                ok = cp_snark_verify(proof, inst, inputs,
                                     Transcript(b"snark_example", log=vlog),
                                     gens, cpc, cic, comm=comm)
                launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
                require(ok, f"golden {fname}: proof does not verify")
                require([list(x) for x in plog] ==
                        [list(x) for x in golden["prover_challenges"]],
                        f"golden {fname}: prover challenges differ")
                require([list(x) for x in vlog] ==
                        [list(x) for x in golden["verifier_challenges"]],
                        f"golden {fname}: verifier challenges differ")
                blob = serialize_snark(proof)
                require(blob.hex() == golden["proof_hex"],
                        f"golden {fname}: proof bytes differ")
                require(launched["ed_add"] > 0 and launched["mont_mul"] > 0,
                        f"golden {fname}: K4/K1 not launched: {launched}")
                log(f"golden {fname}: {len(plog)} prover / {len(vlog)} "
                    f"verifier challenges and {len(blob)} proof bytes equal "
                    f"on the CUDA route; gadget {t_gadget * 1e3:.1f} ms, "
                    f"prove {t_prove * 1e3:.1f} ms; launches {launched}")
    finally:
        for (m, name), value in zip(crossovers, saved):
            setattr(m, name, value)


# ----------------------------------------------------------------------
# phase 5: the main path
# ----------------------------------------------------------------------

def host_work_ms() -> dict:
    """The request's host-side loops at full width, timed alone."""
    from vpin_tpu_torch.curve.fixed_base import scalars_to_digits
    from vpin_tpu_torch.curve.host_ec import E2_ORDER
    from vpin_tpu_torch.curve.weierstrass import scalars_to_bits
    from vpin_tpu_torch.nn.prf import pf_vector
    M = SIZE * SIZE
    rng = random.Random(0)
    out = {}
    t = time.perf_counter()
    rho = pf_vector(b"k" * 32, M, 16)
    out["pf_vector"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    scalars_to_bits(rho, 128)
    out["scalars_to_bits"] = (time.perf_counter() - t) * 1e3
    rs = [rng.randrange(1, E2_ORDER - 1) for _ in range(M)]
    t = time.perf_counter()
    scalars_to_digits(rs)
    out["scalars_to_digits"] = (time.perf_counter() - t) * 1e3
    return out


def run_requests(torch, dev):
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.device import synchronize
    from vpin_tpu_torch.nn.elgamal import KeyPair
    from vpin_tpu_torch.nn.models import run_conv_workload
    key = KeyPair.generate(random.Random(0), device=dev)
    img = np.random.RandomState(0).uniform(0.0, 1.0, (SIZE, SIZE)).astype(
        np.float32)
    results = []
    for req in range(REQUESTS):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        res = run_conv_workload(img, FILTER, key, random.Random(1 + req),
                                defer_checks=True)
        t1 = time.perf_counter()
        res.flush_checks()                     # raises RLCCheckError
        t2 = time.perf_counter()
        fin = res.trace.finalize()
        synchronize(dev)
        t3 = time.perf_counter()
        times = {"encrypt_ms": res.timings["encrypt"] * 1e3,
                 "conv_ms": res.timings["inference"] * 1e3,
                 "rlc_flush_ms": (t2 - t1) * 1e3,
                 "finalize_ms": (t3 - t2) * 1e3,
                 "request_ms": (t3 - t0) * 1e3}
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        log(f"request {req} ({'cold' if req == 0 else 'warm'}): "
            + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
            + f"; launches {launched}")
        results.append((res, fin, times))
    return results


def prove_request(torch, dev, fin):
    """The CP-SNARK proofs of one request's trace, transparent (bench.py's
    proof half with full_snark=False) and with the eval proof (the default),
    each verified on the host.  Returns the full SNARK's numbers."""
    from vpin_tpu_torch import kernels
    from vpin_tpu_torch.gadgets import point_addition, point_mult
    from vpin_tpu_torch.runner.proof_runner import (
        prove_point_add, prove_point_mult, trace_args,
    )
    from vpin_tpu_torch.utils import timer
    add, mult = trace_args(fin)

    def full_size(transparent, matrices):
        A, B, C, nc, nv, _ = matrices
        return transparent + eval_proof_bytes(
            nc, nv, max(len(A[0]), len(B[0]), len(C[0])))

    mult_full = full_size(MULT_PROOF_BYTES,
                          point_mult.build_matrices(len(mult[0]), 128))
    require(full_size(ADD_PROOF_BYTES, point_addition.build_matrices(
        len(add[0]))) == ADD_FULL_PROOF_BYTES,
        "eval_proof_bytes disagrees with the 16-add proof of BENCH_r05.json")
    sizes = {False: (ADD_PROOF_BYTES, MULT_PROOF_BYTES),
             True: (ADD_FULL_PROOF_BYTES, mult_full)}
    out = {}
    for full in (False, True):
        mode = "full SNARK" if full else "transparent"
        before = dict(kernels.LAUNCHES)
        st_add = prove_point_add(*add, tape_seed=PROOF_TAPE_SEED, quiet=True,
                                 device=dev, full_snark=full)
        mid = dict(kernels.LAUNCHES)
        timer.RECORD = []
        try:
            st_mult = prove_point_mult(*mult, tape_seed=PROOF_TAPE_SEED,
                                       quiet=True, device=dev,
                                       full_snark=full)
            record = timer.RECORD
        finally:
            timer.RECORD = None
        after = dict(kernels.LAUNCHES)
        add_l = {k: mid[k] - before[k] for k in before}
        mult_l = {k: after[k] - mid[k] for k in before}
        want_add, want_mult = sizes[full]
        require(st_add.size_bytes == want_add,
                f"{mode} add proof is {st_add.size_bytes} B, want {want_add}")
        require(st_mult.size_bytes == want_mult,
                f"{mode} mult proof is {st_mult.size_bytes} B, want "
                f"{want_mult}")
        require(mult_l["ed_add"] > 0,
                f"K4 not launched in the {mode} mult proof: {mult_l}")
        spans = {}
        for _, label, dt, launched in record:
            ms, n = spans.get(label, (0.0, {}))
            spans[label] = (ms + dt * 1e3, {k: n.get(k, 0) + v
                                            for k, v in launched.items()})
        if full:
            for label in ("SNARK::encode", "R1CSEvalProof::prove"):
                ms, launched = spans.get(label, (0.0, {}))
                require(launched.get("mont_mul", 0) > 0
                        and launched.get("ed_add", 0) > 0,
                        f"{label}: K1 and K4 not both launched: {launched}")
        log(f"{mode} proof: add {st_add.size_bytes} B, mult "
            f"{st_mult.size_bytes} B, both verified; prove_add_ms "
            f"{st_add.gen_ms}, prove_mult_ms {st_mult.gen_ms}, verify_add_ms "
            f"{st_add.ver_ms}, verify_mult_ms {st_mult.ver_ms}")
        log(f"{mode} proof launches: add {add_l}; mult {mult_l}")
        log(f"{mode} mult proof spans: " + "; ".join(
            f"{label} {ms:.1f} ms {({k: v for k, v in n.items() if v})}"
            for label, (ms, n) in spans.items()))
        out[full] = dict(add=st_add.__dict__, mult=st_mult.__dict__,
                         add_launches=add_l, mult_launches=mult_l)
    return out


def check_request(torch, res, fin, req: int) -> None:
    from vpin_tpu_torch.curve.weierstrass import E2, PointW
    from vpin_tpu_torch.nn.host_check import (
        check_conv_outputs, check_conv_trace, corner_pixels)
    from vpin_tpu_torch.nn.models import CONV_FILTERS
    require(res.trace.num_mults == 18 and res.trace.num_adds == 16,
            f"request {req}: {res.trace.num_mults} mults, "
            f"{res.trace.num_adds} adds (want 18, 16)")
    filt = CONV_FILTERS[FILTER]
    check_conv_trace(fin, filt)
    pixels = corner_pixels(SIZE, SIZE, 8, seed=req)
    for half_in, half_out in zip(res.ciphertext, res.outputs):
        image = E2.to_affine_host(half_in)
        out = E2.to_affine_host(PointW(
            *(c.reshape(-1, 8)[pixels] for c in half_out)))
        full = np.empty((SIZE * SIZE,), dtype=object)
        full[pixels] = list(out)
        check_conv_outputs(image, full.reshape(SIZE, SIZE), filt, pixels)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vpin_tpu_torch import kernels

    # -- phase 1 --
    card = smi("name,power.limit")
    log(card)
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    mul32_rate = MUL32_PER_CLOCK_PER_SM * props.multi_processor_count \
        * max_clock_mhz * 1e6
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{props.multi_processor_count} SMs at up to {max_clock_mhz:.0f} MHz: "
        f"{mul32_rate / 1e12:.2f} T 32-bit multiplies/s")

    # -- phase 2 --
    t = time.perf_counter()
    logs = kernels.build()
    log(f"build: {time.perf_counter() - t:.1f} s for {len(logs)} kernels")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- phase 3 --
    k1 = check_mont_mul(torch, dev, mul32_rate)
    k2, P = check_e2_add(torch, dev, mul32_rate)
    k4 = check_ed_add(torch, dev, mul32_rate)
    M = SIZE * SIZE
    f2 = FILTER * FILTER
    k3 = check_ladder(torch, dev, mul32_rate, P, M * f2, 128, f2, M,
                      "rho over windows")
    check_ladder(torch, dev, mul32_rate, P, M, 128, 1, M, "rho over outputs")
    check_ladder(torch, dev, mul32_rate, P, M * f2, 2, 1, f2,
                 "filter weights", plain_repeats=3)
    k5_rows, k5_launches = check_ed_ladder(torch, dev, mul32_rate)
    k5 = k5_rows[LADDER_SHAPES[-1][0]]
    log("host work: " + ", ".join(f"{k} {v:.2f} ms"
                                  for k, v in host_work_ms().items()))

    # -- phase 4 --
    replay_golden(torch, dev)

    # -- phase 5 --
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    results = run_requests(torch, dev)
    conv_launches = dict(kernels.LAUNCHES)
    prove_request(torch, dev, results[1][1])
    launches = dict(kernels.LAUNCHES)
    log(f"launches over {REQUESTS} requests: {conv_launches}; over them and "
        f"one request's proof: {launches}")
    for req, (res, fin, _) in enumerate(results):
        check_request(torch, res, fin, req)
        log(f"request {req}: rLC ok, 18 mults / 16 adds, trace and 8 output "
            f"pixels per half equal to host_ec")
    warm = [r[2]["request_ms"] for r in results[1:]]
    log(f"warm request median {statistics.median(warm):.1f} ms on {card}")

    # -- phase 6 --
    launches["ed_ladder"] = k5_launches        # K5's own path (phase 3)
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on its path: {launches}")
    spec = [("mont_mul", "mont_mul.cu", "vpin_tpu/field/pallas_mont.py:97", k1),
            ("e2_add", "e2_add.cu", "vpin_tpu/curve/pallas_ec.py:119", k2),
            ("e2_scalar_mul", "e2_scalar_mul.cu",
             "vpin_tpu/curve/pallas_ec.py:135", k3),
            ("ed_add", "ed_add.cu", "vpin_tpu/curve/pallas_edwards.py:58", k4),
            ("ed_ladder", "ed_ladder.cu",
             "vpin_tpu/curve/pallas_edwards.py:73", k5)]
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"vpin_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches[name], "max_abs_err": row["max_abs_err"],
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": None}
        for name, src, replaces, row in spec]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
