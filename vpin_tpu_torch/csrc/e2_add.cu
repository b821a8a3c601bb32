// K2: batched complete addition on curve E2, (X3:Y3:Z3) = P + Q.
//
// Replaces vpin_tpu/curve/pallas_ec.py:_ec_add_kernel (entry ec_add_pallas),
// which ran RCB15 over (limb, batch) tiles in VMEM with every field product
// a 16-bit-limb schoolbook pass.
//
// Design for Hopper: one thread per point pair; both points, the RCB15
// working set and all 17 Montgomery products (field.cuh, CIOS over 32-bit
// limbs) stay in registers, so the only memory traffic is 192 bytes in and
// 96 bytes out per pair.
//
// Bound on this card: 17 x 264 = 4,488 32-bit multiplies per pair against
// 288 bytes, about 16 multiplies per byte, above the card's ~5 per byte: the
// kernel is bound by integer multiplies.  The working set is large (two
// points, six t-values, four constant products), so register pressure sets
// occupancy; __launch_bounds__(128) leaves the compiler up to 255 registers
// a thread before it spills (see -Xptxas -v in the build log).
#include "e2.cuh"

#include <cstring>

__global__ void __launch_bounds__(128) e2_add_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
    const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n, CurveConsts cc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Pt p, q;
  pt_load(p, px, py, pz, i);
  pt_load(q, qx, qy, qz, i);
  e2_add(p, p, q, cc);
  pt_store(ox, oy, oz, i, p);
}

// consts: CurveConsts as 33 host uint32 words (n[8], one[8], n0inv, a[8], b3[8]).
// Returns cudaGetLastError() after the launch.
extern "C" int vpin_e2_add(const void* px, const void* py, const void* pz, const void* qx,
                           const void* qy, const void* qz, void* ox, void* oy, void* oz,
                           long long n, const uint32_t* consts, void* stream) {
  CurveConsts cc;
  std::memcpy(&cc, consts, sizeof(CurveConsts));
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  e2_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
      (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      cc);
  return (int)cudaGetLastError();
}
