// K5: batched double-and-add scalar multiplication on ristretto255, [k]P,
// the whole ladder in one launch.
//
// Replaces vpin_tpu/curve/pallas_edwards.py:_ed_ladder_kernel (entry
// ed_ladder_step_pallas), one step acc' = bit ? acc + base : acc,
// base' = base + base per launch, which RistrettoGroup.scalar_mul_bits
// scanned once per bit.  Here each thread runs every step of its point's
// ladder with acc and base in registers, as K3 (e2_scalar_mul.cu) does on
// E2: acc starts at the identity (0 : R : R : 0), the doubling stays the
// unified addition of base with itself (ed.cuh, 9 products with 2d), and acc
// takes acc + base only where the bit is set, so acc after the last bit is
// bit-equal to scanning the reference step.  The doubling after the last bit
// only changes base, which is discarded, so it is skipped.
//
// Bits arrive packed LSB-first in 32-bit words, one row of `words` words per
// scalar, as for K3: point i reads row (i / inner) % nrows, which lets one
// row serve many points without materialising the broadcast.
//
// Bound on this card: each step is one addition for the doubling plus one
// where the bit is set, 9 products of 152 32-bit multiplies each modulo p,
// against 128 bytes of point in and 128 out and the bit words read once:
// bound by integer multiplies by three orders of magnitude.  One thread's
// ladder is a serial chain of 253 or so dependent additions, so the kernel
// is latency-bound at the batch sizes of its callers; one addition is inlined
// once in the step loop to halve the code the instruction cache holds, and a
// warp pays for the add half where any of its lanes has the bit set.
#include "ed.cuh"

#include <cstring>

__global__ void __launch_bounds__(128) ed_ladder_kernel(
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
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    acc.x[j] = 0u;
    acc.y[j] = ec.f.one[j];
    acc.z[j] = ec.f.one[j];
    acc.t[j] = 0u;
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

// consts: EdConsts as 25 host uint32 words (n[8], one[8], n0inv, d2[8]).
// bits: (nrows, words) uint32.  Returns cudaGetLastError() after the launch.
extern "C" int vpin_ed_ladder(const void* px, const void* py, const void* pz, const void* pt,
                              const void* bits, void* ox, void* oy, void* oz, void* ot,
                              long long n, int n_bits, int words, long long inner,
                              long long nrows, const uint32_t* consts, void* stream) {
  EdConsts ec;
  std::memcpy(&ec, consts, sizeof(EdConsts));
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  ed_ladder_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)pt,
      (const uint32_t*)bits, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)ot, n,
      n_bits, words, inner, nrows, ec);
  return (int)cudaGetLastError();
}
