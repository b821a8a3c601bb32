// Unified addition on ristretto255's extended twisted-Edwards coordinates
// (a = -1) over F_p, p = 2^255 - 19, for one CUDA thread, every coordinate
// in registers.  Shared by K4 (ed_add.cu) and K5 (ed_ladder.cu).
#pragma once

#include "field.cuh"

struct EdConsts {
  FieldConsts f;          // F_p
  uint32_t d2[VPIN_NL];   // 2d in Montgomery form
};

struct EdPt {
  uint32_t x[VPIN_NL], y[VPIN_NL], z[VPIN_NL], t[VPIN_NL];
};

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
  fe_mul(A, u, v, c);
  fe_add(u, p.y, p.x, c);
  fe_add(v, q.y, q.x, c);
  fe_mul(B, u, v, c);
  // C = T1 (2d T2), Dd = Z1 (Z2 + Z2)
  fe_mul(v, ec.d2, q.t, c);
  fe_mul(C, p.t, v, c);
  fe_add(v, q.z, q.z, c);
  fe_mul(Dd, p.z, v, c);
  // E = B - A, F = Dd - C, G = Dd + C, H = B + A
  uint32_t E[VPIN_NL], F[VPIN_NL];
  fe_sub(E, B, A, c);
  fe_sub(F, Dd, C, c);
  fe_add(u, Dd, C, c);   // u = G
  fe_add(v, B, A, c);    // v = H
  // X3 = E F, Y3 = G H, T3 = E H, Z3 = F G
  fe_mul(r.x, E, F, c);
  fe_mul(r.y, u, v, c);
  fe_mul(r.t, E, v, c);
  fe_mul(r.z, F, u, c);
}
