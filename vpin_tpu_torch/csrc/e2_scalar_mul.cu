// K3: batched double-and-add scalar multiplication on curve E2, [k]P, the
// whole ladder in one launch.
//
// Replaces vpin_tpu/curve/pallas_ec.py:_ladder_step_kernel (entry
// ec_ladder_step_pallas), one step acc' = bit ? acc + base : acc,
// base' = base + base per launch, which E2.scalar_mul_bits scanned once per
// bit.  Here each thread runs every step of its element's ladder with acc and
// base in registers: acc starts at (0 : R : 0), the doubling stays the
// complete addition of base with itself, and acc takes acc + base only where
// the bit is set, so acc after the last bit is bit-equal to scanning the
// reference step.  The doubling after the last bit only changes base, which
// is discarded, so it is skipped.
//
// Bits arrive packed LSB-first in 32-bit words, one row of `words` words per
// scalar.  Element i reads row (i / inner) % nrows, which broadcasts one row
// over `inner` neighbours (a rho vector over the f*f window of each output
// pixel) or cycles rows over the batch (filter weights over every window)
// without materialising the broadcast.
//
// Bound on this card: each step is one complete addition (4,488 32-bit
// multiplies) for the doubling plus one more where the bit is set, against
// 192 bytes of points and the bit words read once: bound by integer
// multiplies by three orders of magnitude.  One addition is inlined once in
// the step loop (not once for the add and once for the doubling) to halve the
// code the instruction cache holds; a warp pays for the add step where any of
// its lanes has the bit set.
#include "e2.cuh"

#include <cstring>

__global__ void __launch_bounds__(128) e2_scalar_mul_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ bits,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
    long long n, int n_bits, int words, long long inner, long long nrows, CurveConsts cc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* row = bits + ((i / inner) % nrows) * words;

  Pt base, acc, sum;
  pt_load(base, px, py, pz, i);
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    acc.x[j] = 0u;
    acc.y[j] = cc.f.one[j];
    acc.z[j] = 0u;
  }

  uint32_t word = 0;
  for (int k = 0; k < n_bits; ++k) {
    if ((k & 31) == 0) word = row[k >> 5];
    const bool bit = (word >> (k & 31)) & 1u;
    const bool last = (k + 1 == n_bits);
    // step half 0: acc + base where the bit is set; half 1: base + base
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const bool dbl = half == 1;
      if (dbl ? last : !bit) continue;
      Pt lhs;
#pragma unroll
      for (int j = 0; j < VPIN_NL; ++j) {
        lhs.x[j] = dbl ? base.x[j] : acc.x[j];
        lhs.y[j] = dbl ? base.y[j] : acc.y[j];
        lhs.z[j] = dbl ? base.z[j] : acc.z[j];
      }
      e2_add(sum, lhs, base, cc);
      if (dbl) {
        base = sum;
      } else {
        acc = sum;
      }
    }
  }
  pt_store(ox, oy, oz, i, acc);
}

// consts: CurveConsts as 33 host uint32 words (n[8], one[8], n0inv, a[8], b3[8]).
// bits: (nrows, words) uint32.  Returns cudaGetLastError() after the launch.
extern "C" int vpin_e2_scalar_mul(const void* px, const void* py, const void* pz,
                                  const void* bits, void* ox, void* oy, void* oz, long long n,
                                  int n_bits, int words, long long inner, long long nrows,
                                  const uint32_t* consts, void* stream) {
  CurveConsts cc;
  std::memcpy(&cc, consts, sizeof(CurveConsts));
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  e2_scalar_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)bits,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n, n_bits, words, inner, nrows, cc);
  return (int)cudaGetLastError();
}
