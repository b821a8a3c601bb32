// 256-bit prime-field arithmetic for one CUDA thread.
//
// An element is 8 little-endian 32-bit limbs held in registers, in
// Montgomery form with R = 2^256 (the same residues as vpin_tpu's 16 x 16-bit
// limbs, so the two layouts repack losslessly).  Every function takes and
// returns canonical limbs in [0, N): N < 2^255 for both fields of the system
// (l ~ 2^252 and 2^255 - 19), so a sum of two canonical values never carries
// out of 256 bits and one conditional subtract reduces it.
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

// r = t >= N ? t - N : t, for t < 2N < 2^256.
__device__ __forceinline__ void fe_reduce_once(uint32_t r[VPIN_NL], const uint32_t t[VPIN_NL],
                                               const FieldConsts& c) {
  uint32_t d[VPIN_NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    const uint64_t s = (uint64_t)t[j] - c.n[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 32) & 1u;
  }
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) r[j] = borrow ? t[j] : d[j];
}

__device__ __forceinline__ void fe_add(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                       const uint32_t b[VPIN_NL], const FieldConsts& c) {
  uint32_t s[VPIN_NL];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    const uint64_t v = (uint64_t)a[j] + b[j] + carry;
    s[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
  fe_reduce_once(r, s, c);
}

__device__ __forceinline__ void fe_sub(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                       const uint32_t b[VPIN_NL], const FieldConsts& c) {
  uint32_t d[VPIN_NL];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    const uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (uint32_t)(v >> 32) & 1u;
  }
  // a - b < 0: add N back (mod 2^256)
  const uint32_t mask = 0u - borrow;
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    const uint64_t v = (uint64_t)d[j] + (c.n[j] & mask) + carry;
    r[j] = (uint32_t)v;
    carry = (uint32_t)(v >> 32);
  }
}

// Montgomery product r = a * b * 2^-256 mod N (CIOS, word = 32 bits).
// Invariant: t < 2N after every outer step, so 9 words hold it and the
// final value needs one conditional subtract.
__device__ __forceinline__ void fe_mul(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                       const uint32_t b[VPIN_NL], const FieldConsts& c) {
  uint32_t t[VPIN_NL + 2];
#pragma unroll
  for (int j = 0; j < VPIN_NL + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < VPIN_NL; ++i) {
    // t += a[i] * b
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < VPIN_NL; ++j) {
      const uint64_t s = (uint64_t)a[i] * b[j] + t[j] + carry;
      t[j] = (uint32_t)s;
      carry = s >> 32;
    }
    uint64_t s = (uint64_t)t[VPIN_NL] + carry;
    t[VPIN_NL] = (uint32_t)s;
    t[VPIN_NL + 1] = (uint32_t)(s >> 32);
    // t = (t + m * N) / 2^32 with m chosen so the low word cancels
    const uint32_t m = t[0] * c.n0inv;
    s = (uint64_t)m * c.n[0] + t[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < VPIN_NL; ++j) {
      s = (uint64_t)m * c.n[j] + t[j] + carry;
      t[j - 1] = (uint32_t)s;
      carry = s >> 32;
    }
    s = (uint64_t)t[VPIN_NL] + carry;
    t[VPIN_NL - 1] = (uint32_t)s;
    t[VPIN_NL] = t[VPIN_NL + 1] + (uint32_t)(s >> 32);
  }
  // t < 2N < 2^256, so t[VPIN_NL] == 0 here
  fe_reduce_once(r, t, c);
}
