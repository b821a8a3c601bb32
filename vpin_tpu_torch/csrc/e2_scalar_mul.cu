// K3: batched double-and-add scalar multiplication on curve E2, [k]P, the
// whole ladder in one launch.
//
// Replaces vpin_tpu/curve/pallas_ec.py:_ladder_step_kernel (entry
// ec_ladder_step_pallas), one step acc' = bit ? acc + base : acc,
// base' = base + base per launch, which E2.scalar_mul_bits scanned once per
// bit.  Here a group of G lanes (e2.cuh) runs every step of its element's
// ladder: acc starts at (0 : R : 0), the doubling stays the complete
// addition of base with itself, and acc takes acc + base only where the bit
// is set, so acc after the last bit is bit-equal to scanning the reference
// step.  The doubling after the last bit only changes base, which is
// discarded, so it is skipped.  Where the bit is set, acc + base and
// base + base run in the same stages (e2_sched.cuh): 12, 8, 10 and 4
// products, so 6 product rounds with G = 8 and 9 with G = 4, against 34
// products one after another in one thread.
//
// Bits arrive packed LSB-first in 32-bit words, one row of `words` words per
// scalar.  Element i reads row (i / inner) % nrows, which broadcasts one row
// over `inner` neighbours (a rho vector over the f*f window of each output
// pixel) or cycles rows over the batch (filter weights over every window)
// without materialising the broadcast.  The groups of one warp may hold
// different bits, and so run different modes in the same stages.
//
// Bound on this card: each step is one complete addition (4,488 32-bit
// multiplies) for the doubling plus one more where the bit is set, against
// 192 bytes of points and the bit words read once: bound by integer
// multiplies by three orders of magnitude.  On the H100 (PERF.md) 8 lanes
// are fastest at 1,024 ladders, where a few warps an SM wait on their
// chains of products, and 4 at 9,216, where instruction throughput bounds
// and 8 lanes idle in more of the rounds.
#include "e2.cuh"

#include <cstring>

// The group kernel's element: acc, base, a and 3b, then the working slots
// of acc + base and of base + base (e2_sched.cuh, K3_ACC and K3_BASE).
#define K3_SLOTS (E2_EL_TEMP + 2 * E2_NTEMP)

template <int G>
__global__ void __launch_bounds__(E2_ELEMS * G) e2_scalar_mul_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ bits,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
    long long n, int n_bits, int words, long long inner, long long nrows, CurveConsts cc,
    const E2Prog* __restrict__ prog) {
  __shared__ E2Prog s_prog;
  __shared__ uint4 s_slots[E2_ELEMS * K3_SLOTS * E2_SLOT_WORDS / 4];
  e2_copy_prog(s_prog, prog);
  __syncthreads();
  const int lane = threadIdx.x % G;
  const long long e = (long long)blockIdx.x * E2_ELEMS + threadIdx.x / G;
  const bool live = e < n;
  uint32_t* slots =
      reinterpret_cast<uint32_t*>(s_slots) + (threadIdx.x / G) * K3_SLOTS * E2_SLOT_WORDS;
  // j < 3: base from memory; 3..5: acc = (0 : R : 0); then a and 3b
  for (int j = lane; j < 8; j += G) {
    uint32_t v[VPIN_NL];
    const uint32_t* src = j == 0 ? px : j == 1 ? py : pz;
#pragma unroll
    for (int w = 0; w < VPIN_NL; ++w)
      v[w] = j == 6 ? cc.a[w] : j == 7 ? cc.b3[w] : j == 4 ? cc.f.one[w] : 0u;
    if (j < 3 && live) fe_load(v, src + e * VPIN_NL);
    const int slot = j < 3 ? K3_BASE + j : j < 6 ? K3_ACC + j - 3 : j == 6 ? E2_EL_A : E2_EL_B3;
    fe_store(slots + slot * E2_SLOT_WORDS, v);
  }
  __syncwarp();
  const uint32_t* row = bits + (((live ? e : 0) / inner) % nrows) * words;
  uint32_t word = 0;
#pragma unroll 1
  for (int k = 0; k < n_bits; ++k) {
    if ((k & 31) == 0) word = row[k >> 5];
    const int bit = (word >> (k & 31)) & 1u;
    const int mode = live ? (bit ? K3_MODE_ADD : 0) | (k + 1 < n_bits ? K3_MODE_DBL : 0) : 0;
    e2_run<G>(s_prog, mode, lane, slots, cc.f);
  }
  for (int j = lane; j < 3 && live; j += G) {
    uint32_t v[VPIN_NL];
    fe_load(v, slots + (K3_ACC + j) * E2_SLOT_WORDS);
    fe_store((j == 0 ? ox : j == 1 ? oy : oz) + e * VPIN_NL, v);
  }
}

template <int G>
static void launch(const uint32_t* px, const uint32_t* py, const uint32_t* pz,
                   const uint32_t* bits, uint32_t* ox, uint32_t* oy, uint32_t* oz, long long n,
                   int n_bits, int words, long long inner, long long nrows,
                   const CurveConsts& cc, const E2Prog* prog, cudaStream_t stream) {
  const long long blocks = (n + E2_ELEMS - 1) / E2_ELEMS;
  e2_scalar_mul_kernel<G><<<(unsigned)blocks, E2_ELEMS * G, 0, stream>>>(
      px, py, pz, bits, ox, oy, oz, n, n_bits, words, inner, nrows, cc, prog);
}

// consts: CurveConsts as 33 host uint32 words (n[8], one[8], n0inv, a[8], b3[8]).
// bits: (nrows, words) uint32.  lanes: 4 or 8 a ladder; prog: the E2Prog for
// these lanes, in device memory.  Returns the CUDA error of the launch.
extern "C" int vpin_e2_scalar_mul(const void* px, const void* py, const void* pz,
                                  const void* bits, void* ox, void* oy, void* oz, long long n,
                                  int n_bits, int words, long long inner, long long nrows,
                                  const uint32_t* consts, int lanes, const void* prog,
                                  void* stream) {
  CurveConsts cc;
  std::memcpy(&cc, consts, sizeof(CurveConsts));
  if (lanes != 4 && lanes != 8) return (int)cudaErrorInvalidValue;
  (lanes == 4 ? launch<4> : launch<8>)(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)bits,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, n_bits, words, inner, nrows, cc,
      (const E2Prog*)prog, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
