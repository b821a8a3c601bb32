// Complete projective addition on curve E2 (y^2 = x^3 + a x + b over F_l)
// for one CUDA thread, every coordinate in registers.
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
