// K4: batched ristretto255 addition on extended twisted-Edwards coordinates
// over F_p (p = 2^255 - 19), (X3:Y3:Z3:T3) = P + Q, and the two MSM entries
// built from it: the digit table of a base vector in one launch (ed_table)
// and a whole table MSM in two (ed_msm).
//
// Replaces vpin_tpu/curve/pallas_edwards.py:_ed_add_kernel (entry
// ed_add_pallas), which ran add-2008-hwcd-3 (a = -1) over (limb, batch)
// tiles in VMEM with every field product a 16-bit-limb schoolbook pass, and
// which vpin_tpu/curve/msm.py scanned inside one jitted program per table
// build and per MSM.
//
// ed_add: one thread per point pair; both points, the working set and all 9
// Montgomery products (ed.cuh over field.cuh, CIOS over 32-bit limbs) stay in
// registers, so the only memory traffic is 256 bytes in and 128 bytes out per
// pair.  Bound on this card: 9 products per pair; modulo p each takes 152
// 32-bit multiplies (m * p is m * 2^255 - 19 * m), so 1,368 multiplies
// against 384 bytes, about 3.6 multiplies per byte, below the card's ~5 per
// byte: the bytes bind, 0.0075 ms for 2^16 pairs at 3.35 TB/s.  It stays for
// RistrettoGroup.add and sum_points.
//
// ed_table: table[d, i] = d * P_i for d < 256, one thread per column chaining
// the 255 additions table[d] = table[d - 1] + P in registers and writing each
// row as it goes: the same additions on the same operands as the loop it
// replaces, so the limbs are the same.  Bound by multiplies (255 additions
// per 128 bytes in); one column is a serial chain, so at a few thousand
// columns it is latency-bound.
//
// ed_msm: sum_i table[digit_{r,i,w}, i] over the n real columns for every
// row r and window w (launch A), then Horner over the 32 window sums
// (launch B).  Launch A gives each warp one (row, window, chunk of MSM_CHUNK
// points): lane j gathers the points j, j + 32, ... of its chunk straight
// from the table by their uint8 digits and sums them in registers in that
// order, then the lanes fold by a halving tree over shuffles (lane j takes
// lane j + h for h = 16, 8, 4, 2, 1 where that lane holds a sum), and lane 0
// writes the chunk's partial.  Warps run window fastest and chunk slowest, so
// the warps in flight share one chunk's table columns in L2 and one row's
// digits.  Launch B gives each warp one row: lane w folds window w's
// partials in chunk order, and lane 0 runs Horner, MSB first (8 self-
// additions, then + Q_w), in registers.  The plain versions in
// curve/cuda_edwards.py follow this association exactly.  Bound by
// multiplies: rows x (32 x (n - 1) + 288) additions; the bound reads each
// table entry the digits select once, but each window gathers its own
// 128-byte entries.  A block of 256 threads per chunk of 256 points, one
// point per thread folded by a halving tree in shared memory, ran 2.7x
// slower at 1,024 rows x 2,049 points on the H100 (most of its warps wait
// at the tree's barriers) and 13% faster at one row (PERF.md).
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

// ----------------------------------------------------------------------
// ed_table
// ----------------------------------------------------------------------

__global__ void __launch_bounds__(128) ed_table_kernel(
    const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
    const uint32_t* __restrict__ pz, const uint32_t* __restrict__ pt,
    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, uint32_t* __restrict__ oz,
    uint32_t* __restrict__ ot, long long n, EdConsts ec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EdPt p, acc;
  ed_load(p, px, py, pz, pt, i);
  ed_identity(acc, ec);
  const long long row = n * VPIN_NL;
  ed_store(ox, oy, oz, ot, i, acc);
#pragma unroll 1
  for (int d = 1; d < ED_DIGITS; ++d) {
    ed_add(acc, acc, p, ec);
    ed_store(ox + d * row, oy + d * row, oz + d * row, ot + d * row, i, acc);
  }
}

// p: the n base points; o: the table (256, n), row d at o + d * n * 8 words.
extern "C" int vpin_ed_table(const void* px, const void* py, const void* pz, const void* pt,
                             void* ox, void* oy, void* oz, void* ot, long long n,
                             const uint32_t* consts, void* stream) {
  EdConsts ec;
  std::memcpy(&ec, consts, sizeof(EdConsts));
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  ed_table_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)pt,
      (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)ot, n, ec);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------
// ed_msm
// ----------------------------------------------------------------------

#define MSM_WINDOWS 32
// points per warp of launch A, 32 per lane; curve/cuda_edwards.py's
// MSM_CHUNK is the same number
#define MSM_CHUNK 1024
#define MSM_A_THREADS 256
#define MSM_B_WARPS 4

__device__ __forceinline__ void ed_shfl_down(EdPt& q, const EdPt& p, int h) {
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) {
    q.x[j] = __shfl_down_sync(0xffffffffu, p.x[j], h);
    q.y[j] = __shfl_down_sync(0xffffffffu, p.y[j], h);
    q.z[j] = __shfl_down_sync(0xffffffffu, p.z[j], h);
    q.t[j] = __shfl_down_sync(0xffffffffu, p.t[j], h);
  }
}

// Launch A: one warp per (chunk k, row r, window w), w fastest.  Partials
// land at index (r * 32 + w) * nchunks + k.
__global__ void __launch_bounds__(MSM_A_THREADS) ed_msm_windows_kernel(
    const uint32_t* __restrict__ tx, const uint32_t* __restrict__ ty,
    const uint32_t* __restrict__ tz, const uint32_t* __restrict__ tt, long long width,
    const uint8_t* __restrict__ digits, int rows, long long n, long long nchunks,
    uint32_t* __restrict__ sx, uint32_t* __restrict__ sy, uint32_t* __restrict__ sz,
    uint32_t* __restrict__ st, EdConsts ec) {
  const long long warp = ((long long)blockIdx.x * MSM_A_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)rows * MSM_WINDOWS * nchunks) return;   // whole warps
  const int w = (int)(warp % MSM_WINDOWS);
  const long long rk = warp / MSM_WINDOWS;
  const long long r = rk % rows;
  const long long k = rk / rows;
  const long long start = k * MSM_CHUNK;
  const long long end = min(n, start + MSM_CHUNK);
  const uint8_t* dig = digits + r * n * MSM_WINDOWS + w;
  const long long row = width * VPIN_NL;

  EdPt acc, p;
  ed_identity(acc, ec);
  long long i = start + lane;
  if (i < end) {
    const long long d = dig[i * MSM_WINDOWS];
    ed_load(acc, tx + d * row, ty + d * row, tz + d * row, tt + d * row, i);
  }
#pragma unroll 1
  for (i += 32; i < end; i += 32) {
    const long long d = dig[i * MSM_WINDOWS];
    ed_load(p, tx + d * row, ty + d * row, tz + d * row, tt + d * row, i);
    ed_add(acc, acc, p, ec);
  }
  // lanes below `live` hold a sum; the tree keeps that true for every h
  const long long live = end - start;
#pragma unroll 1
  for (int h = 16; h >= 1; h >>= 1) {
    ed_shfl_down(p, acc, h);
    if (lane < h && lane + h < live) ed_add(acc, acc, p, ec);
  }
  if (lane == 0) ed_store(sx, sy, sz, st, (r * MSM_WINDOWS + w) * nchunks + k, acc);
}

// Launch B: one warp per row.  Lane w folds window w's partials in chunk
// order; lane 0 runs Horner over the 32 window sums, MSB first.
__global__ void __launch_bounds__(MSM_B_WARPS * 32) ed_msm_horner_kernel(
    const uint32_t* __restrict__ sx, const uint32_t* __restrict__ sy,
    const uint32_t* __restrict__ sz, const uint32_t* __restrict__ st, int rows,
    long long nchunks, uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
    uint32_t* __restrict__ oz, uint32_t* __restrict__ ot, EdConsts ec) {
  __shared__ EdPt sums[MSM_B_WARPS][MSM_WINDOWS];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * MSM_B_WARPS + wib;
  if (r >= rows) return;                                        // whole warps

  EdPt q, p;
  ed_identity(q, ec);
  const long long base = (r * MSM_WINDOWS + lane) * nchunks;
  if (nchunks > 0) ed_load(q, sx, sy, sz, st, base);
#pragma unroll 1
  for (long long k = 1; k < nchunks; ++k) {
    ed_load(p, sx, sy, sz, st, base + k);
    ed_add(q, q, p, ec);
  }
  sums[wib][lane] = q;
  __syncwarp();
  if (lane != 0) return;

  EdPt acc;
  ed_identity(acc, ec);
#pragma unroll 1
  for (int w = MSM_WINDOWS - 1; w >= 0; --w) {
#pragma unroll 1
    for (int s = 0; s <= 8; ++s) {          // 8 self-additions, then + Q_w
      p = s < 8 ? acc : sums[wib][w];
      ed_add(acc, acc, p, ec);
    }
  }
  ed_store(ox, oy, oz, ot, r, acc);
}

// t: the digit table (256, width); digits: (rows, n, 32) uint8 with
// n <= width; s: scratch for rows * 32 * ceil(n / MSM_CHUNK) partials; o:
// the rows sums.  Launches A (when n > 0) and B; returns the first error.
extern "C" int vpin_ed_msm(const void* tx, const void* ty, const void* tz, const void* tt,
                           long long width, const void* digits, int rows, long long n,
                           void* sx, void* sy, void* sz, void* st, void* ox,
                           void* oy, void* oz, void* ot, const uint32_t* consts,
                           void* stream) {
  EdConsts ec;
  std::memcpy(&ec, consts, sizeof(EdConsts));
  const long long nchunks = (n + MSM_CHUNK - 1) / MSM_CHUNK;
  cudaStream_t s = (cudaStream_t)stream;
  if (nchunks > 0) {
    const long long threads = (long long)rows * MSM_WINDOWS * nchunks * 32;
    const long long blocks = (threads + MSM_A_THREADS - 1) / MSM_A_THREADS;
    ed_msm_windows_kernel<<<(unsigned)blocks, MSM_A_THREADS, 0, s>>>(
        (const uint32_t*)tx, (const uint32_t*)ty, (const uint32_t*)tz, (const uint32_t*)tt,
        width, (const uint8_t*)digits, rows, n, nchunks, (uint32_t*)sx,
        (uint32_t*)sy, (uint32_t*)sz, (uint32_t*)st, ec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + MSM_B_WARPS - 1) / MSM_B_WARPS;
  ed_msm_horner_kernel<<<(unsigned)blocks, MSM_B_WARPS * 32, 0, s>>>(
      (const uint32_t*)sx, (const uint32_t*)sy, (const uint32_t*)sz, (const uint32_t*)st, rows,
      nchunks, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (uint32_t*)ot, ec);
  return (int)cudaGetLastError();
}
