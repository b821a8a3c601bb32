// Complete projective addition on curve E2 (y^2 = x^3 + a x + b over F_l):
// for one CUDA thread, every coordinate in registers (e2_add), and shared by
// a group of lanes of one warp (e2_run, below, which also runs K5's
// ristretto255 schedule, ed_sched.cuh, with the product mod p).
#pragma once

#include "field.cuh"

struct CurveConsts {
  FieldConsts f;
  uint32_t a[VPIN_NL];   // a, Montgomery form
  uint32_t b3[VPIN_NL];  // 3b, Montgomery form
};

struct Pt {
  uint32_t x[VPIN_NL], y[VPIN_NL], z[VPIN_NL];
};

__device__ __forceinline__ void pt_load(Pt& p, const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, long long i) {
  fe_load(p.x, x + i * VPIN_NL);
  fe_load(p.y, y + i * VPIN_NL);
  fe_load(p.z, z + i * VPIN_NL);
}

__device__ __forceinline__ void pt_store(uint32_t* x, uint32_t* y, uint32_t* z, long long i,
                                         const Pt& p) {
  fe_store(x + i * VPIN_NL, p.x);
  fe_store(y + i * VPIN_NL, p.y);
  fe_store(z + i * VPIN_NL, p.z);
}

// r = p + q by Renes-Costello-Batina 2015, Alg. 1 (general a): 17 products.
// The formula and the order of its field operations are those of
// vpin_tpu/curve/pallas_ec.py:_ec_add_rows, and every field operation returns
// canonical limbs, so the projective output is bit-equal to the reference.
// r may alias p or q.
__device__ __forceinline__ void e2_add(Pt& r, const Pt& p, const Pt& q, const CurveConsts& cc) {
  const FieldConsts& c = cc.f;
  uint32_t t0[VPIN_NL], t1[VPIN_NL], t2[VPIN_NL], t3[VPIN_NL], t4[VPIN_NL], t5[VPIN_NL];
  uint32_t u[VPIN_NL], v[VPIN_NL];

  fe_mul(t0, p.x, q.x, c);
  fe_mul(t1, p.y, q.y, c);
  fe_mul(t2, p.z, q.z, c);
  // t3 = (X1 + Y1)(X2 + Y2) - (t0 + t1) = X1Y2 + X2Y1
  fe_add(u, p.x, p.y, c);
  fe_add(v, q.x, q.y, c);
  fe_mul(t3, u, v, c);
  fe_add(u, t0, t1, c);
  fe_sub(t3, t3, u, c);
  // t4 = (X1 + Z1)(X2 + Z2) - (t0 + t2) = X1Z2 + X2Z1
  fe_add(u, p.x, p.z, c);
  fe_add(v, q.x, q.z, c);
  fe_mul(t4, u, v, c);
  fe_add(u, t0, t2, c);
  fe_sub(t4, t4, u, c);
  // t5 = (Y1 + Z1)(Y2 + Z2) - (t1 + t2) = Y1Z2 + Y2Z1
  fe_add(u, p.y, p.z, c);
  fe_add(v, q.y, q.z, c);
  fe_mul(t5, u, v, c);
  fe_add(u, t1, t2, c);
  fe_sub(t5, t5, u, c);

  uint32_t at4[VPIN_NL], b3t2[VPIN_NL], at2[VPIN_NL], b3t4[VPIN_NL];
  fe_mul(at4, cc.a, t4, c);
  fe_mul(b3t2, cc.b3, t2, c);
  fe_mul(at2, cc.a, t2, c);
  fe_mul(b3t4, cc.b3, t4, c);
  // W = b3 t2 + a t4;  U = t1 - W;  V = t1 + W
  fe_add(u, b3t2, at4, c);        // u = W
  fe_add(v, t1, u, c);            // v = V
  fe_sub(u, t1, u, c);            // u = U
  // M = 3 t0 + a t2  (kept in t1, which is dead from here on)
  fe_add(t1, t0, t0, c);
  fe_add(t1, t1, t0, c);
  fe_add(t1, t1, at2, c);
  // S = b3 t4 + a (t0 - a t2)  (kept in t2)
  fe_sub(t0, t0, at2, c);
  fe_mul(t0, cc.a, t0, c);
  fe_add(t2, b3t4, t0, c);

  uint32_t x3[VPIN_NL], y3[VPIN_NL], z3[VPIN_NL];
  fe_mul(y3, u, v, c);            // y3a = U V
  // X3 = U t3 - t5 S
  fe_mul(x3, u, t3, c);
  fe_mul(t4, t5, t2, c);
  fe_sub(x3, x3, t4, c);
  // Y3 = U V + M S
  fe_mul(t4, t1, t2, c);
  fe_add(y3, y3, t4, c);
  // Z3 = t5 V + t3 M
  fe_mul(z3, t5, v, c);
  fe_mul(t4, t3, t1, c);
  fe_add(z3, z3, t4, c);

  fe_copy(r.x, x3);
  fe_copy(r.y, y3);
  fe_copy(r.z, z3);
}

// ---------------------------------------------------------------------
// The group addition: G lanes of one warp share each element
// ---------------------------------------------------------------------
//
// One thread's addition is a chain of 17 dependent products.  Here G lanes
// (G = 4 or 8) own one element, its points and working values in the
// block's shared memory (the slots and layouts of e2_sched.cuh), and run
// the stage schedule of e2_sched.cuh: in each round of a stage every lane
// with a product runs the same fe_mul code on the slots its row names, so
// one addition waits on 4 products (G = 8) or 6 (G = 4), and a pair of
// additions that share their stages (the ladder step) on 6 or 9.  The
// kernel's wrapper passes the schedule laid out as an E2Prog (vpin_tpu_torch/curve/
// e2_sched.py): per mode (the set of additions an element runs: K3's step
// runs acc + base, base + base, both or neither) and per stage, each lane's
// rows with their slots resolved for the element's layout, and the number
// of product rounds; each block copies it into shared memory.  Every lane
// of a warp runs every stage and round (the round count is the warp's
// largest, so lanes of other groups or past the end idle through it) and
// meets the others at a full-warp __syncwarp after each stage: no lane
// leaves early, so the full mask is every group's.  The runner is a
// template on the field product (FeMul, the default, for K2 and K3 mod l;
// ed_ladder.cu's FeMulP for K5 mod p) and on the program's sizes
// (GroupProg).

#include "e2_sched.cuh"

#define E2_ELEMS 16   // elements a block: 16 G threads

static_assert(E2_NSLOT - E2_P0 == E2_NTEMP, "E2_NTEMP counts the working slots");
static_assert(E2_SLOT_WORDS % 4 == 0 && E2_SLOT_WORDS >= VPIN_NL,
              "a slot holds 8 limbs at a 16-byte boundary");

template <int kOps, int kModes, int kStages>
struct __align__(16) GroupProg {
  static constexpr int kNStage = kStages;
  uint32_t op[kOps + 1];   // kind | dst << 8 | a << 16 | b << 24, element slots
  uint16_t start[kModes][kStages][E2_MAXG + 1];   // lane l: [start[l], start[l+1])
  uint8_t rounds[kModes][kStages];                // products on the busiest lane
};
using E2Prog = GroupProg<E2_MAXOPS, E2_MODES, E2_NSTAGE>;
static_assert(sizeof(E2Prog) == (4 * (E2_MAXOPS + 1) + 2 * E2_MODES * E2_NSTAGE * (E2_MAXG + 1) +
                                 E2_MODES * E2_NSTAGE + 15) / 16 * 16,
              "E2Prog is laid out as e2_sched.py packs it");

// r = a + b or a - b, canonical.  Both and their corrections run side by
// side and the kind picks one, so the lanes of a stage take one code path
// and the chain is one carry chain shorter than a subtract then an add.
__device__ __forceinline__ void fe_add_or_sub(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                              const uint32_t b[VPIN_NL], bool sub,
                                              const FieldConsts& c) {
  uint32_t s[VPIN_NL], sn[VPIN_NL], d[VPIN_NL], dn[VPIN_NL], m[VPIN_NL];
  add8(s, a, b);                              // a + b < 2N
  const uint32_t neg = sub8(d, a, b);         // a - b mod 2^256
  const uint32_t keep = sub8(sn, s, c.n);     // s - N; all ones if s < N
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) m[j] = c.n[j] & neg;
  add8(dn, d, m);                             // a - b mod N
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    const uint32_t sum = sn[j] ^ ((s[j] ^ sn[j]) & keep);
    r[j] = sub ? dn[j] : sum;
  }
}

// The generic Montgomery product (any N; K2 and K3: l), as a runner's
// field product.
struct FeMul {
  static __device__ __forceinline__ void mul(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                             const uint32_t b[VPIN_NL], const FieldConsts& c) {
    fe_mul(r, a, b, c);
  }
};

// One row of a program: slots[dst] = slots[a] op slots[b].
template <class Mul>
__device__ __forceinline__ void e2_product(uint32_t op, uint32_t* slots, const FieldConsts& c) {
  uint32_t x[VPIN_NL], y[VPIN_NL];
  fe_load(x, slots + ((op >> 16) & 0xff) * E2_SLOT_WORDS);
  fe_load(y, slots + (op >> 24) * E2_SLOT_WORDS);
  Mul::mul(x, x, y, c);
  fe_store(slots + ((op >> 8) & 0xff) * E2_SLOT_WORDS, x);
}

__device__ __forceinline__ void e2_linear(uint32_t op, uint32_t* slots, const FieldConsts& c) {
  uint32_t x[VPIN_NL], y[VPIN_NL];
  fe_load(x, slots + ((op >> 16) & 0xff) * E2_SLOT_WORDS);
  fe_load(y, slots + (op >> 24) * E2_SLOT_WORDS);
  fe_add_or_sub(x, x, y, (op & 0xff) == E2_SUB, c);
  fe_store(slots + ((op >> 8) & 0xff) * E2_SLOT_WORDS, x);
}

// Run mode `mode` of program p (in shared memory) on the element whose
// slots start at `slots`, as lane `lane` of its group, each product by
// Mul::mul.  Every lane of the warp calls it with the same p.  Each row's
// word is read one row ahead.
template <int G, class Mul = FeMul, class Prog>
__device__ __forceinline__ void e2_run(const Prog& p, int mode, int lane, uint32_t* slots,
                                       const FieldConsts& c) {
#pragma unroll 1
  for (int s = 0; s < Prog::kNStage; ++s) {
    int i = p.start[mode][s][lane];
    const int end = p.start[mode][s][lane + 1];
    const unsigned rounds = __reduce_max_sync(0xffffffffu, p.rounds[mode][s]);
    uint32_t op = p.op[i];
#pragma unroll 1
    for (unsigned r = 0; r < rounds; ++r) {
      // the adds that feed this lane's next product, then the product,
      // the warp's lanes together
      while (i < end && (op & 0xff) != E2_MUL) {
        const uint32_t next = p.op[++i];
        e2_linear(op, slots, c);
        op = next;
      }
      __syncwarp();
      if (i < end) {
        const uint32_t next = p.op[++i];
        e2_product<Mul>(op, slots, c);
        op = next;
      }
    }
    // rows after a lane's last product: a stage without products is all here
    while (i < end) {
      const uint32_t next = p.op[++i];
      e2_linear(op, slots, c);
      op = next;
    }
    __syncwarp();
  }
}

// The block's copy of its program.
template <class Prog>
__device__ __forceinline__ void e2_copy_prog(Prog& dst, const Prog* __restrict__ src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(&dst);
  for (int i = threadIdx.x; i < (int)(sizeof(Prog) / 16); i += blockDim.x) d[i] = __ldg(s + i);
}
