// K1: batched Montgomery product out[i] = a[i] * b[i] * 2^-256 mod N.
//
// Replaces vpin_tpu/field/pallas_mont.py:_mont_mul_kernel (entry
// mont_mul_pallas), which computed the product over 16-bit limbs with a
// separated schoolbook product, m = lo * N' and Kogge-Stone carry passes on a
// (limb, batch) tile in VMEM.
//
// Design for Hopper: one thread per element, the 8 x 32-bit limbs of a, b and
// the CIOS accumulator in registers, 32 x 32 -> 64-bit products chained
// through 64-bit carries (mul.lo/mul.hi plus adds), N and -N^-1 mod 2^32 as
// kernel parameters in the constant bank.
//
// Bound on this card: one product is 264 32-bit multiplies (2 x 64 limb
// products, each a lo and a hi half, plus 8 for m) against 96 bytes moved,
// about 2.75 multiplies per byte.  The H100's integer multiply rate (64 per
// clock per SM) over 3.35 TB/s is about 5 per byte, so a lone product is
// bound by bytes; the design reads each operand once with two 16-byte loads
// and writes the result once.  K2 and K3 reuse the same device function
// where it is bound by multiplies instead.
#include "field.cuh"

#include <cstring>

__global__ void __launch_bounds__(256) mont_mul_kernel(const uint32_t* __restrict__ a,
                                                       const uint32_t* __restrict__ b,
                                                       uint32_t* __restrict__ out, long long n,
                                                       FieldConsts c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[VPIN_NL], y[VPIN_NL], r[VPIN_NL];
  fe_load(x, a + i * VPIN_NL);
  fe_load(y, b + i * VPIN_NL);
  fe_mul(r, x, y, c);
  fe_store(out + i * VPIN_NL, r);
}

// consts: FieldConsts as 17 host uint32 words (n[8], one[8], n0inv).
// Returns cudaGetLastError() after the launch.
extern "C" int vpin_mont_mul(const void* a, const void* b, void* out, long long n,
                             const uint32_t* consts, void* stream) {
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(FieldConsts));
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, c);
  return (int)cudaGetLastError();
}
