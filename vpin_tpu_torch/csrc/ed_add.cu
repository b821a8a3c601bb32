// K4: batched ristretto255 addition on extended twisted-Edwards coordinates
// over F_p (p = 2^255 - 19), (X3:Y3:Z3:T3) = P + Q.
//
// Replaces vpin_tpu/curve/pallas_edwards.py:_ed_add_kernel (entry
// ed_add_pallas), which ran add-2008-hwcd-3 (a = -1) over (limb, batch)
// tiles in VMEM with every field product a 16-bit-limb schoolbook pass.
//
// Design for Hopper: one thread per point pair; both points, the working set
// and all 9 Montgomery products (field.cuh, CIOS over 32-bit limbs) stay in
// registers, so the only memory traffic is 256 bytes in and 128 bytes out
// per pair.  The formula and its operation order are those of
// _ed_add_rows / RistrettoGroup._add_jnp: extended outputs are not unique,
// so any other formula would break byte-equality with vpin_tpu.
//
// Bound on this card: 9 x 264 = 2,376 32-bit multiplies per pair against
// 384 bytes, about 6 multiplies per byte, just above the card's ~5 per byte:
// the kernel is bound by integer multiplies.  The MSM callers launch it on
// batches of a few hundred to a few hundred thousand pairs.
#include "field.cuh"

#include <cstring>

struct EdConsts {
  FieldConsts f;          // F_p
  uint32_t d2[VPIN_NL];   // 2d in Montgomery form
};

__global__ void __launch_bounds__(128) ed_add_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ pt,
    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
    const uint32_t* __restrict__ qz, const uint32_t* __restrict__ qt,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
    uint32_t* __restrict__ ot, long long n, EdConsts ec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const FieldConsts& c = ec.f;
  const long long off = i * VPIN_NL;
  uint32_t x1[VPIN_NL], y1[VPIN_NL], x2[VPIN_NL], y2[VPIN_NL];
  uint32_t u[VPIN_NL], v[VPIN_NL], A[VPIN_NL], B[VPIN_NL], C[VPIN_NL], Dd[VPIN_NL];
  fe_load(x1, px + off);
  fe_load(y1, py + off);
  fe_load(x2, qx + off);
  fe_load(y2, qy + off);
  // A = (Y1 - X1)(Y2 - X2), B = (Y1 + X1)(Y2 + X2)
  fe_sub(u, y1, x1, c);
  fe_sub(v, y2, x2, c);
  fe_mul(A, u, v, c);
  fe_add(u, y1, x1, c);
  fe_add(v, y2, x2, c);
  fe_mul(B, u, v, c);
  // C = T1 (2d T2), Dd = Z1 (Z2 + Z2)
  fe_load(u, qt + off);
  fe_mul(v, ec.d2, u, c);
  fe_load(u, pt + off);
  fe_mul(C, u, v, c);
  fe_load(u, qz + off);
  fe_add(v, u, u, c);
  fe_load(u, pz + off);
  fe_mul(Dd, u, v, c);
  // E = B - A, F = Dd - C, G = Dd + C, H = B + A (x1, y1, x2, y2 reused)
  fe_sub(x1, B, A, c);
  fe_sub(y1, Dd, C, c);
  fe_add(x2, Dd, C, c);
  fe_add(y2, B, A, c);
  // X3 = E F, Y3 = G H, T3 = E H, Z3 = F G
  fe_mul(u, x1, y1, c);
  fe_store(ox + off, u);
  fe_mul(u, x2, y2, c);
  fe_store(oy + off, u);
  fe_mul(u, x1, y2, c);
  fe_store(ot + off, u);
  fe_mul(u, y1, x2, c);
  fe_store(oz + off, u);
}

// consts: EdConsts as 25 host uint32 words (n[8], one[8], n0inv, d2[8]).
// Returns cudaGetLastError() after the launch.
extern "C" int vpin_ed_add(const void* px, const void* py, const void* pz, const void* pt,
                           const void* qx, const void* qy, const void* qz, const void* qt,
                           void* ox, void* oy, void* oz, void* ot, long long n,
                           const uint32_t* consts, void* stream) {
  EdConsts ec;
  std::memcpy(&ec, consts, sizeof(EdConsts));
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  ed_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)pt,
      (const uint32_t*)qx, (const uint32_t*)qy, (const uint32_t*)qz, (const uint32_t*)qt,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)ot, n, ec);
  return (int)cudaGetLastError();
}
