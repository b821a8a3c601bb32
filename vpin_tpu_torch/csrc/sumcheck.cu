// The sumchecks' round sums and binds: one round of a batched sumcheck in
// one launch (two for long halves), one bind of all its tables in one.
//
// Replaces no TPU kernel: vpin_tpu runs these rounds as jnp code
// (vpin_tpu/sumcheck/sumcheck.py:_round_evals, _masked_round_kernel and
// _masked_bind_kernel; spark/product_tree.py), which XLA compiles into a few
// fused programs.  The port ran them as int64 PyTorch code over 8 limbs
// (sumcheck/sumcheck.py's plain versions): each field add or subtract some
// 70 small launches, a round of the SPARK product circuits 1,000-1,500 and a
// bind about 370, on tables of a few thousand elements.  Those rounds were
// bound by launches, with the card idle between them.
//
// sc_round: over T tables (2 to 4) of K stacked instances, each given as its
// lo and hi halves (K, h), the sums over i of the kind's product at the
// points t = 0, 2 (quad) or 0, 2, 3 (cubic, cubic_additive), where a table
// at t is lo + t (hi - lo):
//   quad            A*B
//   cubic           A*B*C
//   cubic_additive  A*(B*C - D)
// Each thread walks a grid-stride range of one instance's half, forms the
// points in registers, takes the products with fe_mul and keeps one running
// sum a point; a block sums its threads by warp shuffles and shared memory.
// An instance's blocks write their partial sums, and a second launch of one
// block an instance adds them (and an earlier chunk's sums, ``acc``).  Sums
// mod l are exact, so any association gives the plain version's limbs.
//
// sc_bind: out = lo + r (hi - lo) for the T tables of one shape, one thread
// an element, r in Montgomery form as kernel parameters.
//
// Tables are read through their strides in 32-bit words (an instance axis
// of stride 0 reads one table for all: the eq table of the product
// circuits), so the wrapper copies nothing.
//
// Bound on this card: per element and point the kind's 1 or 2 products (264
// 32-bit multiplies each) against 64 bytes a table, each read once.  A
// cubic round is 6 products over 192 bytes, about 8 multiplies a byte,
// above the H100's ~5 (16.73 T multiplies/s over 3.35 TB/s), so a long
// round is bound by its multiplies, a quad round (2 products over 128
// bytes) and a bind (one product, 96 bytes) by their bytes.  The product
// circuits' rounds are short (K x h of 12 to 400,000 elements), where the
// launch and one thread's chain of dependent products bound the time: the
// wrapper gives an instance one block for every 512 elements of its half,
// up to 1,024 blocks in all (cuda_sumcheck.round_blocks), so below that a
// thread walks at most two elements before the blocks' partial sums meet
// in the second launch.  Measured on the H100 (PERF.md): 4-18 us a round
// of the conv3 proof, where the plain version took 3-38 ms; 56-60% of the
// bound on a 2^21-element chunk, 89% for its bind.
#include "field.cuh"

#include <cstring>

#define SC_THREADS 256
#define SC_WARPS (SC_THREADS / 32)
#define SC_MAX_TABLES 4
#define SC_BIND_THREADS 256

// One table's halves: element (k, i) of lo at lo + k * lo_k + i * lo_i
// (in 32-bit words), and the same for hi.
struct ScTable {
  const uint32_t* lo;
  const uint32_t* hi;
  long long lo_k, lo_i, hi_k, hi_i;
};

struct ScTables {
  ScTable t[SC_MAX_TABLES];
};

struct ScScalar {
  uint32_t w[VPIN_NL];
};

enum { SC_QUAD = 0, SC_CUBIC = 1, SC_CUBIC_ADDITIVE = 2 };

template <int KIND>
struct ScKind {
  static constexpr int T = KIND == SC_QUAD ? 2 : KIND == SC_CUBIC ? 3 : 4;
  static constexpr int P = KIND == SC_QUAD ? 2 : 3;
};

__device__ __forceinline__ void fe_zero(uint32_t r[VPIN_NL]) {
#pragma unroll
  for (int j = 0; j < VPIN_NL; ++j) r[j] = 0;
}

// The kind's product of the tables' values v at one point.
template <int KIND>
__device__ __forceinline__ void sc_term(uint32_t r[VPIN_NL], uint32_t v[][VPIN_NL],
                                        const FieldConsts& c) {
  if constexpr (KIND == SC_QUAD) {
    fe_mul(r, v[0], v[1], c);
  } else if constexpr (KIND == SC_CUBIC) {
    fe_mul(r, v[0], v[1], c);
    fe_mul(r, r, v[2], c);
  } else {
    fe_mul(r, v[1], v[2], c);
    fe_sub(r, r, v[3], c);
    fe_mul(r, v[0], r, c);
  }
}

// Sums s over the block into thread 0's s (the other threads' s are left
// partial).  sh: SC_WARPS x P elements of shared memory.
template <int P>
__device__ __forceinline__ void block_sum(uint32_t s[P][VPIN_NL],
                                          uint32_t (*sh)[P][VPIN_NL],
                                          const FieldConsts& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t o[VPIN_NL];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int j = 0; j < VPIN_NL; ++j) o[j] = __shfl_down_sync(0xffffffffu, s[p][j], off);
      fe_add(s[p], s[p], o, c);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) fe_copy(sh[warp][p], s[p]);
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (lane < SC_WARPS) fe_copy(s[p], sh[lane][p]);
      else fe_zero(s[p]);
    }
#pragma unroll
    for (int off = SC_WARPS / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int j = 0; j < VPIN_NL; ++j) o[j] = __shfl_down_sync(0xffffffffu, s[p][j], off);
        fe_add(s[p], s[p], o, c);
      }
    }
  }
  __syncthreads();   // sh is free again
}

// Thread 0 writes instance k's sums to out (P, K) plus acc's, if given.
template <int P>
__device__ __forceinline__ void write_sums(uint32_t s[P][VPIN_NL], long long k, long long K,
                                           uint32_t* __restrict__ out,
                                           const uint32_t* __restrict__ acc,
                                           const FieldConsts& c) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (acc != nullptr) {
      uint32_t a[VPIN_NL];
      fe_load(a, acc + (p * K + k) * VPIN_NL);
      fe_add(s[p], s[p], a, c);
    }
    fe_store(out + (p * K + k) * VPIN_NL, s[p]);
  }
}

// Grid (blocks an instance, instances).  With partial null each instance
// has one block, which writes its sums (and acc's) to out (P, K); else
// block b of instance k writes its sums to partial[(k * gridDim.x + b) * P].
template <int KIND>
__global__ void __launch_bounds__(SC_THREADS) sc_round_kernel(
    ScTables tabs, long long K, long long h, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ acc, uint32_t* __restrict__ partial, FieldConsts c) {
  constexpr int T = ScKind<KIND>::T, P = ScKind<KIND>::P;
  __shared__ uint32_t sh[SC_WARPS][P][VPIN_NL];
  const long long stride = (long long)gridDim.x * SC_THREADS;
  for (long long k = blockIdx.y; k < K; k += gridDim.y) {
    uint32_t s[P][VPIN_NL];
#pragma unroll
    for (int p = 0; p < P; ++p) fe_zero(s[p]);
    for (long long i = (long long)blockIdx.x * SC_THREADS + threadIdx.x; i < h; i += stride) {
      uint32_t v[T][VPIN_NL], d[T][VPIN_NL], x[VPIN_NL];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const ScTable tb = tabs.t[t];
        fe_load(v[t], tb.lo + k * tb.lo_k + i * tb.lo_i);
        fe_load(x, tb.hi + k * tb.hi_k + i * tb.hi_i);
        fe_sub(d[t], x, v[t], c);                   // hi - lo
      }
      sc_term<KIND>(x, v, c);                        // t = 0
      fe_add(s[0], s[0], x, c);
#pragma unroll
      for (int t = 0; t < T; ++t) {                  // t = 2: lo + 2 (hi - lo)
        fe_add(v[t], v[t], d[t], c);
        fe_add(v[t], v[t], d[t], c);
      }
      sc_term<KIND>(x, v, c);
      fe_add(s[1], s[1], x, c);
      if constexpr (P == 3) {
#pragma unroll
        for (int t = 0; t < T; ++t) fe_add(v[t], v[t], d[t], c);   // t = 3
        sc_term<KIND>(x, v, c);
        fe_add(s[P - 1], s[P - 1], x, c);
      }
    }
    block_sum<P>(s, sh, c);
    if (partial == nullptr) {
      write_sums<P>(s, k, K, out, acc, c);
    } else if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        fe_store(partial + ((k * gridDim.x + blockIdx.x) * P + p) * VPIN_NL, s[p]);
    }
  }
}

// One block an instance: the sum of its nb partial sums (and acc's) to out.
template <int P>
__global__ void __launch_bounds__(SC_THREADS) sc_round_reduce_kernel(
    const uint32_t* __restrict__ partial, long long K, int nb, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ acc, FieldConsts c) {
  __shared__ uint32_t sh[SC_WARPS][P][VPIN_NL];
  for (long long k = blockIdx.x; k < K; k += gridDim.x) {
    uint32_t s[P][VPIN_NL], x[VPIN_NL];
#pragma unroll
    for (int p = 0; p < P; ++p) fe_zero(s[p]);
    for (int b = threadIdx.x; b < nb; b += SC_THREADS) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        fe_load(x, partial + ((k * nb + b) * P + p) * VPIN_NL);
        fe_add(s[p], s[p], x, c);
      }
    }
    block_sum<P>(s, sh, c);
    write_sums<P>(s, k, K, out, acc, c);
  }
}

// Grid (blocks, tables): table blockIdx.y's elements (k, i), k < K, i < m,
// bound to out + t * o_t + k * o_k + i * o_i (words).
__global__ void __launch_bounds__(SC_BIND_THREADS) sc_bind_kernel(
    ScTables tabs, long long K, long long m, uint32_t* __restrict__ out, long long o_t,
    long long o_k, long long o_i, ScScalar r, FieldConsts c) {
  const int t = blockIdx.y;
  // static indices into the parameter struct (the table is uniform)
  const ScTable tb = t == 0 ? tabs.t[0] : t == 1 ? tabs.t[1] : t == 2 ? tabs.t[2] : tabs.t[3];
  uint32_t rr[VPIN_NL];
  fe_copy(rr, r.w);
  const long long n = K * m;
  for (long long e = (long long)blockIdx.x * SC_BIND_THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * SC_BIND_THREADS) {
    const long long k = e / m, i = e - k * m;
    uint32_t lo[VPIN_NL], x[VPIN_NL];
    fe_load(lo, tb.lo + k * tb.lo_k + i * tb.lo_i);
    fe_load(x, tb.hi + k * tb.hi_k + i * tb.hi_i);
    fe_sub(x, x, lo, c);
    fe_mul(x, rr, x, c);
    fe_add(x, lo, x, c);
    fe_store(out + t * o_t + k * o_k + i * o_i, x);
  }
}

// desc: 6 words a table (lo, hi as addresses; lo_k, lo_i, hi_k, hi_i).
static ScTables read_tables(const long long* desc, int T) {
  ScTables tabs;
  std::memset(&tabs, 0, sizeof(tabs));
  for (int t = 0; t < T; ++t) {
    const long long* d = desc + 6 * t;
    tabs.t[t].lo = reinterpret_cast<const uint32_t*>(d[0]);
    tabs.t[t].hi = reinterpret_cast<const uint32_t*>(d[1]);
    tabs.t[t].lo_k = d[2];
    tabs.t[t].lo_i = d[3];
    tabs.t[t].hi_k = d[4];
    tabs.t[t].hi_i = d[5];
  }
  return tabs;
}

template <int KIND>
static int launch_round(const ScTables& tabs, long long K, long long h, uint32_t* out,
                        const uint32_t* acc, uint32_t* partial, int nb, const FieldConsts& c,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)nb, (unsigned)(K < 65535 ? K : 65535));
  sc_round_kernel<KIND><<<grid, SC_THREADS, 0, stream>>>(
      tabs, K, h, out, acc, nb > 1 ? partial : nullptr, c);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || nb == 1) return rc;
  const unsigned blocks = (unsigned)(K < 65535 ? K : 65535);
  sc_round_reduce_kernel<ScKind<KIND>::P><<<blocks, SC_THREADS, 0, stream>>>(
      partial, K, nb, out, acc, c);
  return (int)cudaGetLastError();
}

// kind: 0 quad, 1 cubic, 2 cubic_additive, over 2, 3 or 4 tables of desc.
// out: (P, K) sums, plus acc's (P, K) where acc is not null.  nb: blocks an
// instance; above 1, partial holds K x nb x P elements and a second launch
// sums them.  consts: FieldConsts as 17 words.  Returns cudaGetLastError()
// after each launch.
extern "C" int vpin_sc_round(const long long* desc, int kind, long long K, long long h,
                             void* out, const void* acc, void* partial, int nb,
                             const uint32_t* consts, void* stream) {
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(FieldConsts));
  const int T = kind == SC_QUAD ? 2 : kind == SC_CUBIC ? 3 : 4;
  const ScTables tabs = read_tables(desc, T);
  uint32_t* o = (uint32_t*)out;
  const uint32_t* a = (const uint32_t*)acc;
  uint32_t* w = (uint32_t*)partial;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case SC_QUAD: return launch_round<SC_QUAD>(tabs, K, h, o, a, w, nb, c, s);
    case SC_CUBIC: return launch_round<SC_CUBIC>(tabs, K, h, o, a, w, nb, c, s);
    case SC_CUBIC_ADDITIVE:
      return launch_round<SC_CUBIC_ADDITIVE>(tabs, K, h, o, a, w, nb, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// T <= 4 tables of desc, each K x m elements, bound at r (8 words of r R mod
// l) into out + t * o_t + k * o_k + i * o_i.  blocks: a table's blocks.
extern "C" int vpin_sc_bind(const long long* desc, int T, long long K, long long m, void* out,
                            long long o_t, long long o_k, long long o_i, int blocks,
                            const uint32_t* r, const uint32_t* consts, void* stream) {
  FieldConsts c;
  std::memcpy(&c, consts, sizeof(FieldConsts));
  ScScalar rs;
  std::memcpy(rs.w, r, sizeof(rs.w));
  if (T < 1 || T > SC_MAX_TABLES) return (int)cudaErrorInvalidValue;
  const ScTables tabs = read_tables(desc, T);
  sc_bind_kernel<<<dim3((unsigned)blocks, (unsigned)T), SC_BIND_THREADS, 0,
                   (cudaStream_t)stream>>>(tabs, K, m, (uint32_t*)out, o_t, o_k, o_i, rs, c);
  return (int)cudaGetLastError();
}
