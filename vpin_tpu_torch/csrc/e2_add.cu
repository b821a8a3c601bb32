// K2: batched complete addition on curve E2, (X3:Y3:Z3) = P + Q.
//
// Replaces vpin_tpu/curve/pallas_ec.py:_ec_add_kernel (entry ec_add_pallas),
// which ran RCB15 over (limb, batch) tiles in VMEM with every field product
// a 16-bit-limb schoolbook pass.
//
// Two kernels, one function.  The entry e2_add gives each pair to a group
// of 8 lanes (e2.cuh): the stages of e2_sched.cuh take 4 product rounds
// where one thread chains 17 products, which is what counts on the
// main path's batches of 1 to a few thousand pairs, a few warps an SM.  The
// entry e2_add_wide keeps one thread a pair, both points and all 17
// products in registers: from 8,192 pairs the card's instruction
// throughput bounds, and idle lanes cost more than the chain (PERF.md, the
// crossover that cuda_ec.add_lanes applies; 4 lanes a pair beat 8 only at
// 4,096 pairs, by 3%, too little for a third kernel).
//
// Bound on this card: 17 x 264 = 4,488 32-bit multiplies per pair against
// 288 bytes, about 16 multiplies per byte, above the card's ~5 per byte: the
// kernels are bound by integer multiplies.
#include "e2.cuh"

#include <cstring>

// One thread a pair (the entry e2_add_wide).  __launch_bounds__(128) leaves
// the compiler up to 255 registers a thread for the working set.
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

// The group kernel's element: P, Q, a and 3b, the working slots
// (e2_sched.cuh, K2_P and K2_Q).
#define K2_SLOTS (E2_EL_TEMP + E2_NTEMP)

template <int G>
__global__ void __launch_bounds__(E2_ELEMS * G) e2_add_group_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
    const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz, uint32_t* __restrict__ ox,
    uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, long long n, CurveConsts cc,
    const E2Prog* __restrict__ prog) {
  __shared__ E2Prog s_prog;
  __shared__ uint4 s_slots[E2_ELEMS * K2_SLOTS * E2_SLOT_WORDS / 4];
  e2_copy_prog(s_prog, prog);
  __syncthreads();
  const int lane = threadIdx.x % G;
  const long long e = (long long)blockIdx.x * E2_ELEMS + threadIdx.x / G;
  const bool live = e < n;
  uint32_t* slots =
      reinterpret_cast<uint32_t*>(s_slots) + (threadIdx.x / G) * K2_SLOTS * E2_SLOT_WORDS;
  // j < 6: the coordinates of P and Q; then a and 3b
  for (int j = lane; j < 8; j += G) {
    uint32_t v[VPIN_NL];
    const uint32_t* src = j == 0 ? px : j == 1 ? py : j == 2 ? pz : j == 3 ? qx : j == 4 ? qy : qz;
#pragma unroll
    for (int w = 0; w < VPIN_NL; ++w) v[w] = j == 6 ? cc.a[w] : j == 7 ? cc.b3[w] : 0u;
    if (j < 6 && live) fe_load(v, src + e * VPIN_NL);
    const int slot = j < 3 ? K2_P + j : j < 6 ? K2_Q + j - 3 : j == 6 ? E2_EL_A : E2_EL_B3;
    fe_store(slots + slot * E2_SLOT_WORDS, v);
  }
  __syncwarp();
  e2_run<G>(s_prog, live ? 1 : 0, lane, slots, cc.f);
  for (int j = lane; j < 3 && live; j += G) {
    uint32_t v[VPIN_NL];
    fe_load(v, slots + (K2_P + j) * E2_SLOT_WORDS);
    fe_store((j == 0 ? ox : j == 1 ? oy : oz) + e * VPIN_NL, v);
  }
}

// consts: CurveConsts as 33 host uint32 words (n[8], one[8], n0inv, a[8], b3[8]).
// prog: the E2Prog for 8 lanes, in device memory.  Returns the CUDA error
// of the launch.
extern "C" int vpin_e2_add(const void* px, const void* py, const void* pz, const void* qx,
                           const void* qy, const void* qz, void* ox, void* oy, void* oz,
                           long long n, const uint32_t* consts, const void* prog, void* stream) {
  CurveConsts cc;
  std::memcpy(&cc, consts, sizeof(CurveConsts));
  const long long blocks = (n + E2_ELEMS - 1) / E2_ELEMS;
  e2_add_group_kernel<8><<<(unsigned)blocks, E2_ELEMS * 8, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
      (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      cc, (const E2Prog*)prog);
  return (int)cudaGetLastError();
}

// The one-thread kernel: the same arguments but the program.
extern "C" int vpin_e2_add_wide(const void* px, const void* py, const void* pz, const void* qx,
                                const void* qy, const void* qz, void* ox, void* oy, void* oz,
                                long long n, const uint32_t* consts, void* stream) {
  CurveConsts cc;
  std::memcpy(&cc, consts, sizeof(CurveConsts));
  const long long blocks = (n + 127) / 128;
  e2_add_kernel<<<(unsigned)blocks, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
      (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, n,
      cc);
  return (int)cudaGetLastError();
}
