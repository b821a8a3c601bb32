// Unified addition on ristretto255's extended twisted-Edwards coordinates
// (a = -1) over F_p, p = 2^255 - 19, for one CUDA thread, every coordinate
// in registers.  Shared by K4 (ed_add.cu: ed_add, ed_table, ed_msm) and K5
// (ed_ladder.cu).
#pragma once

#include "field.cuh"

struct EdConsts {
  FieldConsts f;          // F_p
  uint32_t d2[VPIN_NL];   // 2d in Montgomery form
};

struct EdPt {
  uint32_t x[VPIN_NL], y[VPIN_NL], z[VPIN_NL], t[VPIN_NL];
};

// digits of an 8-bit window: rows of an MSM digit table
#define ED_DIGITS 256

// p = the identity (0 : 1 : 1 : 0), 1 in Montgomery form
__device__ __forceinline__ void ed_identity(EdPt& p, const EdConsts& ec) {
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    p.x[j] = 0u;
    p.y[j] = ec.f.one[j];
    p.z[j] = ec.f.one[j];
    p.t[j] = 0u;
  }
}

__device__ __forceinline__ void ed_load(EdPt& p, const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, const uint32_t* t, long long i) {
  fe_load(p.x, x + i * VPIN_NL);
  fe_load(p.y, y + i * VPIN_NL);
  fe_load(p.z, z + i * VPIN_NL);
  fe_load(p.t, t + i * VPIN_NL);
}

__device__ __forceinline__ void ed_store(uint32_t* x, uint32_t* y, uint32_t* z, uint32_t* t,
                                         long long i, const EdPt& p) {
  fe_store(x + i * VPIN_NL, p.x);
  fe_store(y + i * VPIN_NL, p.y);
  fe_store(z + i * VPIN_NL, p.z);
  fe_store(t + i * VPIN_NL, p.t);
}

// t += m * p for p = 2^255 - 19, as t + m * 2^255 - 19 m: m * 2^255 goes
// into words 7 and 8, then 19 m comes out of words 0 and 1 with the borrow
// carried to the top (t + m * 2^255 >= 19 m, so the 320-bit result is exact).
// 2 multiplies, 2 shifts and 13 adds where the generic row (field.cuh's
// mad_row) takes 16 multiplies and 11 adds.
__device__ __forceinline__ void redc_row_p(uint32_t t[VPIN_NL + 2], uint32_t m) {
  asm("{\n\t"
      "add.cc.u32  %7, %7, %10;\n\t"
      "addc.cc.u32 %8, %8, %11;\n\t"
      "addc.u32    %9, %9, 0;\n\t"
      "sub.cc.u32  %0, %0, %12;\n\t"
      "subc.cc.u32 %1, %1, %13;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.cc.u32 %8, %8, 0;\n\t"
      "subc.u32    %9, %9, 0;\n\t}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(m << 31), "r"(m >> 1), "r"(m * 19u), "r"(__umulhi(m, 19u)));
}

// fe_mul for N = p = 2^255 - 19 only (c must hold p's constants): the same
// CIOS and the same canonical result, each reduction row redc_row_p.
__device__ __forceinline__ void fe_mul_p(uint32_t r[VPIN_NL], const uint32_t a[VPIN_NL],
                                         const uint32_t b[VPIN_NL], const FieldConsts& c) {
  uint32_t t[VPIN_NL + 2];
#pragma unroll
  for (int j = 0; j < VPIN_NL + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < VPIN_NL; ++i) {
    mad_row<false>(t, a[i], b);
    redc_row_p(t, t[0] * c.n0inv);
#pragma unroll
    for (int j = 0; j < VPIN_NL + 1; ++j) t[j] = t[j + 1];
    t[VPIN_NL + 1] = 0;
  }
  fe_reduce_once(r, t, c);
}

// r = p + q by add-2008-hwcd-3 (a = -1): 9 Montgomery products.  The formula
// and its operations are those of vpin_tpu/curve/pallas_edwards.py:
// _ed_add_rows and RistrettoGroup._add_jnp.  Extended outputs are not
// unique, so any other formula (a dedicated doubling included) would break
// limb equality with vpin_tpu.  r may alias p or q.
__device__ __forceinline__ void ed_add(EdPt& r, const EdPt& p, const EdPt& q,
                                       const EdConsts& ec) {
  const FieldConsts& c = ec.f;
  uint32_t u[VPIN_NL], v[VPIN_NL], A[VPIN_NL], B[VPIN_NL], C[VPIN_NL], Dd[VPIN_NL];
  // A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2)
  fe_sub(u, p.y, p.x, c);
  fe_sub(v, q.y, q.x, c);
  fe_mul_p(A, u, v, c);
  fe_add(u, p.y, p.x, c);
  fe_add(v, q.y, q.x, c);
  fe_mul_p(B, u, v, c);
  // C = T1 (2d T2), Dd = Z1 (Z2 + Z2)
  fe_mul_p(v, ec.d2, q.t, c);
  fe_mul_p(C, p.t, v, c);
  fe_add(v, q.z, q.z, c);
  fe_mul_p(Dd, p.z, v, c);
  // E = B - A, F = Dd - C, G = Dd + C, H = B + A
  uint32_t E[VPIN_NL], F[VPIN_NL];
  fe_sub(E, B, A, c);
  fe_sub(F, Dd, C, c);
  fe_add(u, Dd, C, c);   // u = G
  fe_add(v, B, A, c);    // v = H
  // X3 = E F, Y3 = G H, T3 = E H, Z3 = F G
  fe_mul_p(r.x, E, F, c);
  fe_mul_p(r.y, u, v, c);
  fe_mul_p(r.t, E, v, c);
  fe_mul_p(r.z, F, u, c);
}
