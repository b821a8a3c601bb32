// 256-bit prime-field arithmetic for one CUDA thread.
//
// An element is 8 little-endian 32-bit limbs held in registers, in
// Montgomery form with R = 2^256 (the same residues as vpin_tpu's 16 x 16-bit
// limbs, so the two layouts repack losslessly).  Every function takes and
// returns canonical limbs in [0, N): N < 2^255 for both fields of the system
// (l ~ 2^252 and 2^255 - 19), so a sum of two canonical values never carries
// out of 256 bits and one conditional subtract reduces it.  Every carry and
// borrow runs in a PTX carry chain (add.cc / addc, sub.cc / subc, mad.lo.cc /
// madc.hi.cc), each chain inside one asm statement.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define VPIN_NL 8

// Field constants, filled by the host wrapper and passed by value (kernel
// parameters live in the constant bank, so every limb is a uniform operand).
struct FieldConsts {
  uint32_t n[VPIN_NL];    // modulus N
  uint32_t one[VPIN_NL];  // R mod N: 1 in Montgomery form
  uint32_t n0inv;         // -N^{-1} mod 2^32
};

__device__ __forceinline__ void fe_load(uint32_t r[VPIN_NL], const uint32_t* p) {
  // elements sit at 32-byte strides; the wrapper checks 16-byte alignment
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = q[0];
  const uint4 hi = q[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void fe_store(uint32_t* p, const uint32_t r[VPIN_NL]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

__device__ __forceinline__ void fe_copy(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL]) {
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) r[j] = a[j];
}

// r = a + b mod 2^256, one add.cc chain.
__device__ __forceinline__ void add8(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                     const uint32_t b[VPIN_NL]) {
  asm("{\n\t"
      "add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;\n\t}"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
}

// r = a - b mod 2^256, one sub.cc chain; returns all ones if a < b, else 0.
__device__ __forceinline__ uint32_t sub8(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                         const uint32_t b[VPIN_NL]) {
  uint32_t borrow;
  asm("{\n\t"
      "sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %9, %9;\n\t}"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]),
        "=r"(r[6]), "=r"(r[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]),
        "r"(b[6]), "r"(b[7]));
  return borrow;
}

// r = t >= N ? t - N : t, for t < 2N < 2^256.
__device__ __forceinline__ void fe_reduce_once(uint32_t r[VPIN_NL], const uint32_t t[VPIN_NL],
                                               const FieldConsts& c) {
  uint32_t d[VPIN_NL];
  const uint32_t keep = sub8(d, t, c.n);
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) r[j] = d[j] ^ ((t[j] ^ d[j]) & keep);
}

__device__ __forceinline__ void fe_add(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                       const uint32_t b[VPIN_NL], const FieldConsts& c) {
  uint32_t s[VPIN_NL];
  add8(s, a, b);   // a + b < 2N < 2^256
  fe_reduce_once(r, s, c);
}

__device__ __forceinline__ void fe_sub(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                       const uint32_t b[VPIN_NL], const FieldConsts& c) {
  uint32_t d[VPIN_NL], m[VPIN_NL];
  const uint32_t neg = sub8(d, a, b);
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) m[j] = c.n[j] & neg;
  add8(r, d, m);   // a - b < 0: add N back (mod 2^256)
}

// t += a * b for a 10-word accumulator t and an 8-word b.  The products of
// the even limbs of b land on disjoint word pairs (lo at word j, hi at j + 1),
// so they go into t in one mad.lo.cc / madc.hi.cc chain; the products of the
// odd limbs fill words 1..8 as plain halves, with no additions between them,
// and one add.cc chain merges them.  The multiplies of the odd limbs lie off
// the carry chains, which keeps the dependent chain per row short: on the
// H100 this was faster, in throughput and in one thread's latency, than one
// madc chain over all lo halves then one over all hi halves, and than the
// compiler's own 64-bit multiply-adds.  The carry flag lives only inside
// one asm statement, so each chain is one.  kWide takes each odd product as
// one wide multiply rather than a low and a high one: faster in the generic
// product (K1 to K3), slower in ed.cuh's product mod p (K4, K5), measured
// side by side on the H100 (PERF.md).
template <bool kWide>
__device__ __forceinline__ void mad_row(uint32_t t[VPIN_NL + 2], uint32_t a,
                                        const uint32_t b[VPIN_NL]) {
  asm("{\n\t"
      "mad.lo.cc.u32  %0, %10, %11, %0;\n\t"
      "madc.hi.cc.u32 %1, %10, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %10, %14, %6;\n\t"
      "madc.hi.cc.u32 %7, %10, %14, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a), "r"(b[0]), "r"(b[2]), "r"(b[4]), "r"(b[6]));
  uint32_t u[VPIN_NL];   // u[j] at word j + 1
#pragma unroll
  for (int j = 0; j < VPIN_NL; j += 2) {
    if (kWide) {
      const uint64_t w = (uint64_t)a * b[j + 1];
      u[j] = (uint32_t)w;
      u[j + 1] = (uint32_t)(w >> 32);
    } else {
      u[j] = a * b[j + 1];
      u[j + 1] = __umulhi(a, b[j + 1]);
    }
  }
  asm("{\n\t"
      "add.cc.u32  %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32    %8, %8, 0;\n\t}"
      : "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
        "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(u[0]), "r"(u[1]), "r"(u[2]), "r"(u[3]), "r"(u[4]), "r"(u[5]),
        "r"(u[6]), "r"(u[7]));
}

// Montgomery product r = a * b * 2^-256 mod N (CIOS, word = 32 bits), the
// rows of limb products in PTX carry chains (mad_row).  Invariant: t < 2N
// after every outer step, so the tenth word only takes carries inside a step
// and the final value needs one conditional subtract.  r may alias a or b:
// they are not read after the last row.
__device__ __forceinline__ void fe_mul(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                       const uint32_t b[VPIN_NL], const FieldConsts& c) {
  uint32_t t[VPIN_NL + 2];
#pragma unroll
  for (int j = 0; j < VPIN_NL + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < VPIN_NL; ++i) {
    mad_row<true>(t, a[i], b);           // t += a[i] * b
    const uint32_t m = t[0] * c.n0inv;   // t + m * N is 0 mod 2^32
    mad_row<true>(t, m, c.n);
#pragma unroll
    for (int j = 0; j < VPIN_NL + 1; ++j) t[j] = t[j + 1];   // t /= 2^32
    t[VPIN_NL + 1] = 0;
  }
  // t < 2N < 2^256, so t[VPIN_NL] == 0 here
  fe_reduce_once(r, t, c);
}
