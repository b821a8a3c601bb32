// K5: batched double-and-add scalar multiplication on ristretto255, [k]P,
// the whole ladder in one launch.
//
// Replaces vpin_tpu/curve/pallas_edwards.py:_ed_ladder_kernel (entry
// ed_ladder_step_pallas), one step acc' = bit ? acc + base : acc,
// base' = base + base per launch, which RistrettoGroup.scalar_mul_bits
// scanned once per bit.  Here a group of G lanes of one warp runs every step
// of its point's ladder, as K3 (e2_scalar_mul.cu) does on E2: acc starts at
// the identity (0 : R : R : 0), the doubling stays the unified addition of
// base with itself (ed.cuh, 9 products with 2d), and acc takes acc + base
// only where the bit is set, so acc after the last bit is bit-equal to
// scanning the reference step.  The doubling after the last bit only
// changes base, which is discarded, so it is skipped.  The lanes run the
// stage schedule of ed_sched.cuh on the group runner of e2.cuh (e2_run)
// with the product mod p: where the bit is set, acc + base and base + base
// share their stages and their 2d T2, 7 + 2 + 8 products, so 3 product
// rounds a step with G = 8 and 5 with G = 4, against 18 products one after
// another in one thread.
//
// Bits arrive packed LSB-first in 32-bit words, one row of `words` words per
// scalar, as for K3: point i reads row (i / inner) % nrows, which lets one
// row serve many points without materialising the broadcast.  The groups of
// one warp may hold different bits, and so run different modes in the same
// stages.
//
// Bound on this card: each step is one addition for the doubling plus one
// where the bit is set, 9 products of 152 32-bit multiplies each modulo p,
// against 128 bytes of point in and 128 out and the bit words read once:
// bound by integer multiplies by three orders of magnitude.  A ladder is a
// chain of 253 or so dependent steps, so at its callers' batches (a few to
// a few thousand ladders, a few warps an SM) the kernel waits on each
// step's rounds of products; the group cuts them from 18 to 3 or 5.  Once
// the card fills, lanes that idle through a round cost more than the
// chain: on the H100 4 lanes a ladder beat 8 from 8,192 ladders, and the
// one-thread kernel, kept as lane count 1 (every coordinate in registers,
// no idle lane), beats 4 lanes from 16,384 (PERF.md, the crossovers that
// cuda_edwards.ed_ladder_lanes applies).
#include "e2.cuh"
#include "ed.cuh"
#include "ed_sched.cuh"

#include <cstring>

// One thread a ladder (lane count 1): acc and base in registers, each step
// ed.cuh's ed_add for the addition where the bit is set and for the
// doubling.  __launch_bounds__(128) leaves the compiler up to 255
// registers a thread.
__global__ void __launch_bounds__(128) ed_ladder_thread_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ pt,
    const uint32_t* __restrict__ bits, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, uint32_t* __restrict__ ot, long long n, int n_bits, int words,
    long long inner, long long nrows, EdConsts ec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* row = bits + ((i / inner) % nrows) * words;

  EdPt base, acc, sum;
  ed_load(base, px, py, pz, pt, i);
  ed_identity(acc, ec);

  uint32_t word = 0;
  for (int k = 0; k < n_bits; ++k) {
    if ((k & 31) == 0) word = row[k >> 5];
    const bool bit = (word >> (k & 31)) & 1u;
    const bool last = (k + 1 == n_bits);
    // step half 0: acc + base where the bit is set; half 1: base + base.
    // One addition inlined once in the step loop halves the code the
    // instruction cache holds; a warp pays for the add half where any of
    // its lanes has the bit set.
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const bool dbl = half == 1;
      if (dbl ? last : !bit) continue;
      EdPt lhs;
#pragma unroll
      for (int j = 0; j < VPIN_NL; ++j) {
        lhs.x[j] = dbl ? base.x[j] : acc.x[j];
        lhs.y[j] = dbl ? base.y[j] : acc.y[j];
        lhs.z[j] = dbl ? base.z[j] : acc.z[j];
        lhs.t[j] = dbl ? base.t[j] : acc.t[j];
      }
      ed_add(sum, lhs, base, ec);
      if (dbl) {
        base = sum;
      } else {
        acc = sum;
      }
    }
  }
  ed_store(ox, oy, oz, ot, i, acc);
}

// The product mod p = 2^255 - 19 (ed.cuh) as the runner's field product.
struct FeMulP {
  static __device__ __forceinline__ void mul(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                             const uint32_t b[VPIN_NL], const FieldConsts& c) {
    fe_mul_p(r, a, b, c);
  }
};

using EdProg = GroupProg<ED_MAXOPS, ED_MODES, ED_NSTAGE>;
static_assert(sizeof(EdProg) == (4 * (ED_MAXOPS + 1) + 2 * ED_MODES * ED_NSTAGE * (E2_MAXG + 1) +
                                 ED_MODES * ED_NSTAGE + 15) / 16 * 16,
              "EdProg is laid out as e2_sched.py packs it");
static_assert(ED_NSLOT - ED_P0 == ED_NTEMP, "ED_NTEMP counts the working slots");

// The group kernel's element: acc, base, 2d, 2d T2, then the working slots
// of acc + base and of base + base (ed_sched.cuh, K5_ACC and K5_BASE).
#define K5_SLOTS (ED_EL_TEMP + 2 * ED_NTEMP)

template <int G>
__global__ void __launch_bounds__(E2_ELEMS * G) ed_ladder_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ pt,
    const uint32_t* __restrict__ bits, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, uint32_t* __restrict__ ot, long long n, int n_bits, int words,
    long long inner, long long nrows, EdConsts ec, const EdProg* __restrict__ prog) {
  __shared__ EdProg s_prog;
  __shared__ uint4 s_slots[E2_ELEMS * K5_SLOTS * E2_SLOT_WORDS / 4];
  e2_copy_prog(s_prog, prog);
  __syncthreads();
  const int lane = threadIdx.x % G;
  const long long e = (long long)blockIdx.x * E2_ELEMS + threadIdx.x / G;
  const bool live = e < n;
  uint32_t* slots =
      reinterpret_cast<uint32_t*>(s_slots) + (threadIdx.x / G) * K5_SLOTS * E2_SLOT_WORDS;
  // j < 4: base from memory; 4..7: acc = (0 : R : R : 0); 8: 2d
  for (int j = lane; j < 9; j += G) {
    uint32_t v[VPIN_NL];
    const uint32_t* src = j == 0 ? px : j == 1 ? py : j == 2 ? pz : pt;
#pragma unroll
    for (int w = 0; w < VPIN_NL; ++w)
      v[w] = j == 8 ? ec.d2[w] : (j == 5 || j == 6) ? ec.f.one[w] : 0u;
    if (j < 4 && live) fe_load(v, src + e * VPIN_NL);
    const int slot = j < 4 ? K5_BASE + j : j < 8 ? K5_ACC + j - 4 : ED_EL_D2;
    fe_store(slots + slot * E2_SLOT_WORDS, v);
  }
  __syncwarp();
  const uint32_t* row = bits + (((live ? e : 0) / inner) % nrows) * words;
  uint32_t word = 0;
#pragma unroll 1
  for (int k = 0; k < n_bits; ++k) {
    if ((k & 31) == 0) word = row[k >> 5];
    const int bit = (word >> (k & 31)) & 1u;
    const int mode = live ? (bit ? K5_MODE_ADD : 0) | (k + 1 < n_bits ? K5_MODE_DBL : 0) : 0;
    e2_run<G, FeMulP>(s_prog, mode, lane, slots, ec.f);
  }
  for (int j = lane; j < 4 && live; j += G) {
    uint32_t v[VPIN_NL];
    fe_load(v, slots + (K5_ACC + j) * E2_SLOT_WORDS);
    fe_store((j == 0 ? ox : j == 1 ? oy : j == 2 ? oz : ot) + e * VPIN_NL, v);
  }
}

template <int G>
static void launch(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                   const uint32_t* pt, const uint32_t* bits, uint32_t* ox, uint32_t* oy,
                   uint32_t* oz, uint32_t* ot, long long n, int n_bits, int words, long long inner,
                   long long nrows, const EdConsts& ec, const EdProg* prog, cudaStream_t stream) {
  const long long blocks = (n + E2_ELEMS - 1) / E2_ELEMS;
  ed_ladder_kernel<G><<<(unsigned)blocks, E2_ELEMS * G, 0, stream>>>(
      px, py, pz, pt, bits, ox, oy, oz, ot, n, n_bits, words, inner, nrows, ec, prog);
}

// consts: EdConsts as 25 host uint32 words (n[8], one[8], n0inv, d2[8]).
// bits: (nrows, words) uint32.  lanes: 1 (the one-thread kernel), 4 or 8 a
// ladder; prog: the EdProg for 4 or 8 lanes, in device memory (unread with
// 1).  Returns the CUDA error of the launch.
extern "C" int vpin_ed_ladder(const void* px, const void* py, const void* pz, const void* pt,
                              const void* bits, void* ox, void* oy, void* oz, void* ot,
                              long long n, int n_bits, int words, long long inner,
                              long long nrows, const uint32_t* consts, int lanes,
                              const void* prog, void* stream) {
  EdConsts ec;
  std::memcpy(&ec, consts, sizeof(EdConsts));
  if (lanes == 1) {
    ed_ladder_thread_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)pt,
        (const uint32_t*)bits, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)ot, n,
        n_bits, words, inner, nrows, ec);
    return (int)cudaGetLastError();
  }
  if (lanes != 4 && lanes != 8) return (int)cudaErrorInvalidValue;
  (lanes == 4 ? launch<4> : launch<8>)(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)pt,
      (const uint32_t*)bits, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)ot, n,
      n_bits, words, inner, nrows, ec, (const EdProg*)prog, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
