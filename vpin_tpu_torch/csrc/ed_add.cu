// K4: batched ristretto255 addition on extended twisted-Edwards coordinates
// over F_p (p = 2^255 - 19), (X3:Y3:Z3:T3) = P + Q.
//
// Replaces vpin_tpu/curve/pallas_edwards.py:_ed_add_kernel (entry
// ed_add_pallas), which ran add-2008-hwcd-3 (a = -1) over (limb, batch)
// tiles in VMEM with every field product a 16-bit-limb schoolbook pass.
//
// Design for Hopper: one thread per point pair; both points, the working set
// and all 9 Montgomery products (ed.cuh over field.cuh, CIOS over 32-bit
// limbs) stay in registers, so the only memory traffic is 256 bytes in and
// 128 bytes out per pair.
//
// Bound on this card: 9 products per pair; modulo p each takes 152 32-bit
// multiplies (m * p is m * 2^255 - 19 * m), so 1,368 multiplies against
// 384 bytes, about 3.6 multiplies per byte, below the card's ~5 per byte:
// the bytes bind, 0.0075 ms for 2^16 pairs at 3.35 TB/s.  The MSM callers
// launch it on batches of a few hundred up to about 2^21 pairs (the first
// fold of the SPARK comb_ops commitment, 1,024 rows of 2,048 pairs).
#include "ed.cuh"

#include <cstring>

__global__ void __launch_bounds__(128) ed_add_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ pt,
    const uint32_t* __restrict__ qx, const uint32_t* __restrict__ qy,
    const uint32_t* __restrict__ qz, const uint32_t* __restrict__ qt,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
    uint32_t* __restrict__ ot, long long n, EdConsts ec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EdPt p, q;
  ed_load(p, px, py, pz, pt, i);
  ed_load(q, qx, qy, qz, qt, i);
  ed_add(p, p, q, ec);
  ed_store(ox, oy, oz, ot, i, p);
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
