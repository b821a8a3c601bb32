// K1: batched Montgomery product out[i] = a[i] * b[i] * 2^-256 mod N, and
// the batched power out[i] = a[i]^e for one public exponent e.
//
// Replaces vpin_tpu/field/pallas_mont.py:_mont_mul_kernel (entry
// mont_mul_pallas), which computed the product over 16-bit limbs with a
// separated schoolbook product, m = lo * N' and Kogge-Stone carry passes on a
// (limb, batch) tile in VMEM.  vpin_tpu's PrimeField.pow_bits (Fermat
// inversion, the square root of ristretto255's encode and decode) is a
// lax.scan of that product, one device program on the TPU; mont_pow is its
// counterpart, one launch instead of one per square and per multiply.
//
// Design for Hopper: one thread per element, the 8 x 32-bit limbs of a, b and
// the CIOS accumulator in registers, every row of 32 x 32-bit limb products a
// PTX carry chain (field.cuh), N and -N^-1 mod 2^32 as kernel parameters in
// the constant bank.
//
// Bound on this card: one product is 264 32-bit multiplies (2 x 64 limb
// products, each a lo and a hi half, plus 8 for m) against 96 bytes moved,
// about 2.75 multiplies per byte.  The H100's integer multiply rate (64 per
// clock per SM) over 3.35 TB/s is about 5 per byte, so a lone product is
// bound by bytes: each thread issues the loads of MONT_MUL_ELEMS elements
// before it multiplies, so more bytes are in flight per thread, and every
// operand is read once and every result written once.  mont_pow is bound by
// its multiplies (a 253-bit exponent is over 300 products per 64 bytes);
// its exponent bits are kernel parameters, the same for every lane, so the
// square-and-multiply steps never diverge.
#include "field.cuh"

#include <cstring>

#define MONT_MUL_THREADS 256
#define MONT_MUL_ELEMS 2

__global__ void __launch_bounds__(MONT_MUL_THREADS) mont_mul_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    uint32_t* __restrict__ out, long long n, FieldConsts c) {
  const long long first =
      (long long)blockIdx.x * (MONT_MUL_THREADS * MONT_MUL_ELEMS) + threadIdx.x;
  uint32_t x[MONT_MUL_ELEMS][VPIN_NL], y[MONT_MUL_ELEMS][VPIN_NL];
#pragma unroll
  for (int k = 0; k < MONT_MUL_ELEMS; ++k) {
    const long long i = first + (long long)k * MONT_MUL_THREADS;
    if (i < n) {
      fe_load(x[k], a + i * VPIN_NL);
      fe_load(y[k], b + i * VPIN_NL);
    }
  }
#pragma unroll
  for (int k = 0; k < MONT_MUL_ELEMS; ++k) {
    const long long i = first + (long long)k * MONT_MUL_THREADS;
    if (i < n) {
      fe_mul(x[k], x[k], y[k], c);
      fe_store(out + i * VPIN_NL, x[k]);
    }
  }
}

// The exponent: its bits LSB-first in 32-bit words, and how many of them the
// MSB-first square-and-multiply walks (leading zero bits square 1 into 1).
struct PowExp {
  uint32_t w[VPIN_NL];
  int nbits;
};

__global__ void __launch_bounds__(256) mont_pow_kernel(const uint32_t* __restrict__ a,
                                                       uint32_t* __restrict__ out, long long n,
                                                       FieldConsts c, PowExp e) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t base[VPIN_NL], x[VPIN_NL];
  fe_load(base, a + i * VPIN_NL);
  fe_copy(x, c.one);
  // words from the top; the word index is static after unrolling, so the
  // parameter array is read from the constant bank, not copied to local memory
#pragma unroll
  for (int w = VPIN_NL - 1; w >= 0; --w) {
    const uint32_t word = e.w[w];
    const int top = min(32, e.nbits - 32 * w);
#pragma unroll 1
    for (int k = top - 1; k >= 0; --k) {
      fe_mul(x, x, x, c);
      if ((word >> k) & 1u) fe_mul(x, x, base, c);
    }
  }
  fe_store(out + i * VPIN_NL, x);
}

// consts: FieldConsts as 17 host uint32 words (n[8], one[8], n0inv).
// Returns cudaGetLastError() after the launch.
extern "C" int vpin_mont_mul(const void* a, const void* b, void* out, long long n,
                             const uint32_t* consts, void* stream) {
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(FieldConsts));
  const long long per_block = MONT_MUL_THREADS * MONT_MUL_ELEMS;
  const long long blocks = (n + per_block - 1) / per_block;
  mont_mul_kernel<<<(unsigned)blocks, MONT_MUL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, c);
  return (int)cudaGetLastError();
}

// exp: the exponent's 8 words, LSB first; nbits <= 256 of them are walked.
extern "C" int vpin_mont_pow(const void* a, void* out, long long n, const uint32_t* consts,
                             const uint32_t* exp, int nbits, void* stream) {
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(FieldConsts));
  PowExp e;
  std::memcpy(e.w, exp, sizeof(e.w));
  e.nbits = nbits;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  mont_pow_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (uint32_t*)out, n, c, e);
  return (int)cudaGetLastError();
}
