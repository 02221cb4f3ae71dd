// Count-Min sketch (paper Ex. 5, HAVING) on Hopper: build and query.
//
// cms_build replaces cms_build_kernel (src/repro/kernels/cms_sketch.py:39)
// and builds the engine's per-lane HAVING sketches (core.sketches.cms_build,
// an XLA scatter-add in the JAX package): a weighted scatter-add of every
// key into rows counters of table[lane][r][hash_r(key)].
//
// The build is a partial-table build. Each lane is built by a few
// persistent CTAs, each walking its share of the lane in rounds of
// CMS_THREADS * CMS_UNROLL keys, all of a round's loads issued before the
// first key is used, into a partial table in shared memory; then each CTA
// writes its partial with coalesced plain stores, straight into the output
// when it is the lane's only CTA, else into a workspace that cms_reduce
// sums counter by counter over the partials in a fixed order (no global
// atomics). A table above the shared-memory budget is built with global
// atomics into the zeroed output. The layout (CTAs a lane: two an SM where
// two CTAs' shared memory fits, else one, shared among the lanes; the
// int32 shadow's limit; the workspace) is cms_plan's, here alone: the
// wrapper asks cms_build_plan for the workspace's bytes.
//
// What held the kernel it replaced back (its time split, PERF.md):
// reading and hashing with one load in flight a thread, and, for f32, the
// shared add, which Hopper compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN) that the zipf column's hot key makes retry. So an f32
// table keeps an int32 shadow partial beside it: a weight that is an
// integer of small enough magnitude (every main-path weight) goes there
// with a native ATOMS.ADD, and each partial is read out as int + f32. The
// flush was not the cost. Grouping a warp's equal keys first
// (__match_any_sync) removed the same-address conflicts but was measured
// slower at every main-path shape and CTA count (PERF.md), so the build
// does not do it.
//
// cms_build_atomic is the kernel this build replaced (528 short-lived CTAs
// a lane, every key's rows atomics into a shared partial, every non-zero
// counter of every partial flushed with a global atomic). No entry point of
// the package launches it: chip_smoke.py holds the new build against it.
//
// cms_query replaces cms_query_kernel (src/repro/kernels/cms_sketch.py:72):
// per key, the minimum over rows of table[r][hash_r(key)]; the engine's
// form fuses "estimate > threshold" and writes the keep mask instead. It is
// a persistent, table-resident query (cms_query_persistent): as many CTAs
// as the SMs hold, each of which copies the table into its shared memory
// once (16-byte copies) and then takes 8 keys a thread a step by two
// 16-byte loads, gathers the rows' counters from shared memory and writes
// one vector store of estimates or keep bytes a unit of 4 keys
// (query.cuh). A power-of-two width takes a shift or a mask for the range
// reduction. A table above the shared-memory budget is gathered from
// global memory by the same kernel; cms_query_plan gives the route and the
// grid. What held the grid-stride query it replaced back (cms_query_grid,
// kept for chip_smoke.py's witness): one dependent chain a key, its
// gathers global loads, the engine family's modulo by a run-time width.
// Its reads are the reference's: the Pallas query's one-hot product for
// the kernels' family, jnp.min for the engine's (see the query below).
//
// Tables: int32 (COUNT and integer SUM, and every narrower integer table,
// which the wrapper wraps from it) wraps mod 2^32 in any order of adds;
// uint32 is built as int32 and queried with unsigned minima; f32 equals the
// plain sequential sum for integer-valued weights whose sums stay below
// 2^24, which covers every main-path shape, and is then the same from run
// to run. A non-integer f32 weight gives a sum in another order than the
// sequential one: the shared atomics in whatever order the warps of a CTA
// reach them, then a CTA's integer part, then the partials in CTA order
// (the last two steps are fixed, the first is not).
//
// A float16 table is the reference's f16 scatter-add: each counter takes
// its entries' weights in index order, rounded to f16 after every add.
// XLA adds two f16 values as their f32 sum rounded to f16; the f32 sum is
// itself a rounding of the exact sum, but 24 >= 2 * 11 + 2 bits make that
// double rounding innocuous (Figueroa's bound for + in binary formats), so
// it equals the correctly rounded f16 sum, which is what __hadd gives. The
// adds do not associate, so the f16 build is a walk (cms_build_walk<__half>)
// and not a reduction:
// one CTA a (row, lane) takes the lane's keys in chunks of CMS_F16_CHUNK,
// sorts each chunk in shared memory by (column, position) with a bitonic
// network (the position in the key keeps equal columns in entry order),
// and then the first thread of each column's run adds the run in order into
// the row, kept in shared memory when it fits and in the output otherwise.
// Each counter has one writer a chunk and the chunks go in order, so no
// atomics are needed. Its chain is the hottest counter's entries, one
// dependent f16 add each.
//
// An f32 table's adds flush (--ftz=true, as XLA's do), so they do not
// associate either once a sum can pass below FLT_MIN, which takes weights
// of both signs in one counter (ROADMAP Queue 3 A28). The partial build
// flags the signs of an f32 build's weights (one vote a CTA), and a walk
// follows it that returns at once unless the weights take both signs, and
// then builds every counter in the reference's order, a flush after each
// add: for the engine's family the same walk in f32 (cms_build_walk<float>,
// entry order, as the reference's scatter-add and the plain build add),
// for the kernels' family cms_build_blocks (the Pallas build's blocks, each
// summed in XLA's reduction order, ROADMAP Queue 3 A29). Weights of one
// sign keep the partial build.
//
// Hash family at run time: 0 is the Pallas kernels'
// hash_mod(key, width, seed + 101 r) on uint32 lanes, 2 the same on an int32
// key in the Pallas kernels' signed arithmetic (hash.cuh; a probe of -1 is
// dropped: it adds nothing and reads 0), 1 the engine's
// multi_hash(key, width, rows, seed).
//
// What bounds them: bytes (read the keys and weights once, write the table,
// or the estimates or the mask, once). The build takes 2-4x its bytes at
// every main-path shape, most likely in its hashing: rows mixes and range
// reductions a key in 32-bit integer arithmetic. The query's hashing is
// about as many instructions a key as its bytes allow (PERF.md gives its
// SASS count and the issue floor it implies).
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "hash.cuh"
#include "query.cuh"

#define CMS_THREADS 512
#define CMS_UNROLL 8
#define CMS_F16_CHUNK 1024  // keys a chunk of the f16 build
#define CMS_F16_THREADS 512

namespace {

// Families 0 and 1 (the query of families 0 and 1 takes only these).
__device__ __forceinline__ int cms_hash(uint32_t key, int r, int width,
                                        uint32_t seed, int family) {
  return family == 0
             ? cheetah_hash_mod(key, width, seed + 101u * static_cast<uint32_t>(r))
             : cheetah_multi_hash(key, width, r, seed);
}

// The column of row r in any family, for the builds: the engine family's
// modulo by a power-of-two width (wmask = width - 1, else 0) is a mask, for
// the hash is the build's largest cost after the bytes (an integer modulo
// by a width known only at run time takes some twenty instructions); family
// 2 is the signed hash of an int32 key (-1: a dropped probe).
__device__ __forceinline__ int cms_hash_build(uint32_t key, int r, int width,
                                              uint32_t wmask, uint32_t seed,
                                              int family) {
  if (family == 1 && wmask)
    return static_cast<int>(
        cheetah_mix32(key, static_cast<uint32_t>(r) * 0x9E3779B9u + seed) &
        wmask);
  if (family == 2)
    return cheetah_hash_mod_i32(key, width,
                                seed + 101u * static_cast<uint32_t>(r));
  return cms_hash(key, r, width, seed, family);
}

// int32 adds wrap mod 2^32 like the reference's int32 scatter-add.
template <typename T>
__device__ __forceinline__ T cms_add(T a, T b) {
  if constexpr (std::is_integral<T>::value)
    return static_cast<T>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
  else
    return __fadd_rn(a, b);
}

// The retired build (see the header).
template <typename T>
__global__ void cms_build_atomic_kernel(const uint32_t* __restrict__ keys,
                                        const T* __restrict__ weights,
                                        T* __restrict__ table, int shard_len,
                                        int rows, int width, uint32_t seed,
                                        int family, int per_cta, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* st = reinterpret_cast<T*>(smem);
  const int cells = rows * width;
  const long long base = static_cast<long long>(blockIdx.y) * shard_len;
  T* lane_table = table + static_cast<long long>(blockIdx.y) * cells;
  T* dst = staged ? st : lane_table;
  if (staged) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) st[c] = T(0);
    __syncthreads();
  }
  const int lo = blockIdx.x * per_cta;
  const int hi = min(shard_len, lo + per_cta);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const uint32_t key = keys[base + i];
    const T v = weights ? weights[base + i] : T(1);
    for (int r = 0; r < rows; ++r) {
      const int c = cms_hash_build(key, r, width, 0u, seed, family);
      if (c >= 0) atomicAdd(dst + r * width + c, v);
    }
  }
  if (staged) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += blockDim.x)
      if (st[c] != T(0)) atomicAdd(lane_table + c, st[c]);
  }
}

// The build: grid (ctas, lanes), CMS_THREADS threads. CTA p of a lane takes
// the rounds p, p + ctas, ... of CMS_THREADS * CMS_UNROLL keys; in a round,
// thread t holds the keys t + u * CMS_THREADS (u < CMS_UNROLL), all loaded
// before the first is used. kWeights: 0 unit weights (COUNT), 1 weights read
// from memory. An f32 table whose ``shadow`` > 0 keeps a second, int32
// partial beside it: a weight that is an integer of magnitude <= shadow is
// added there with a native integer atomic, where an f32 shared add is a
// compare-and-swap loop (ATOMS.CAST.SPIN); cms_plan picks shadow so that no
// int32 partial can overflow, and each partial is then int + f32 (exact
// while it stays below 2^24).
template <typename T, int kWeights>
__global__ void __launch_bounds__(CMS_THREADS, 2)
    cms_build_partial(const uint32_t* __restrict__ keys,
                      const T* __restrict__ weights, T* __restrict__ table,
                      T* __restrict__ work, long long shard_len, int rows,
                      int width, uint32_t seed, int family, int staged,
                      float shadow, unsigned* __restrict__ signs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* st = reinterpret_cast<T*>(smem);
  const int cells = rows * width;
  int* ist = reinterpret_cast<int*>(st + cells);  // the int32 shadow
  const bool use_shadow = !std::is_integral<T>::value && staged && shadow > 0;
  const int ctas = gridDim.x;
  const long long base = static_cast<long long>(blockIdx.y) * shard_len;
  T* lane_table = table + static_cast<long long>(blockIdx.y) * cells;
  T* dst = staged ? st : lane_table;
  if (staged) {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) st[c] = T(0);
    if (use_shadow)
      for (int c = threadIdx.x; c < cells; c += blockDim.x) ist[c] = 0;
    __syncthreads();
  }
  const uint32_t wmask = (width & (width - 1)) == 0 ? width - 1 : 0u;
  const long long per_round = static_cast<long long>(CMS_THREADS) * CMS_UNROLL;
  // the signs of this thread's weights, as their least and greatest (with
  // two bool ORs in their place the f32 build took 1.6x as long, PERF.md)
  float wmin = 0.0f, wmax = 0.0f;
  for (long long r0 = blockIdx.x * per_round; r0 < shard_len;
       r0 += ctas * per_round) {
    uint32_t k[CMS_UNROLL];
    T v[CMS_UNROLL];
#pragma unroll
    for (int u = 0; u < CMS_UNROLL; ++u) {
      const long long i = r0 + u * CMS_THREADS + threadIdx.x;
      const bool in = i < shard_len;
      k[u] = in ? __ldg(keys + base + i) : 0u;
      v[u] = kWeights ? (in ? __ldg(weights + base + i) : T(0)) : T(1);
    }
#pragma unroll
    for (int u = 0; u < CMS_UNROLL; ++u) {
      const long long i = r0 + u * CMS_THREADS + threadIdx.x;
      if (i >= shard_len) continue;
      const T s = v[u];
      if constexpr (!std::is_integral<T>::value) {
        wmin = fminf(wmin, static_cast<float>(s));  // a subnormal reads 0
        wmax = fmaxf(wmax, static_cast<float>(s));
      }
      // an integer-valued f32 weight goes to the int32 shadow
      const bool as_int = use_shadow && static_cast<float>(s) == truncf(
          static_cast<float>(s)) && fabsf(static_cast<float>(s)) <= shadow;
      for (int r = 0; r < rows; ++r) {
        const int c = cms_hash_build(k[u], r, width, wmask, seed, family);
        if (c < 0) continue;
        if (as_int)
          atomicAdd(ist + r * width + c, static_cast<int>(s));
        else
          atomicAdd(dst + r * width + c, s);
      }
    }
  }
  if (signs) {  // an f32 table's weights: which signs they take
    const int any_neg = __syncthreads_or(wmin < 0.0f);
    const int any_pos = __syncthreads_or(wmax > 0.0f);
    if (threadIdx.x == 0 && (any_neg || any_pos))
      atomicOr(signs, (any_neg ? 1u : 0u) | (any_pos ? 2u : 0u));
  }
  if (!staged) return;
  __syncthreads();
  T* out = ctas == 1 ? lane_table
                     : work + (static_cast<long long>(blockIdx.y) * ctas +
                               blockIdx.x) * cells;
  for (int c = threadIdx.x; c < cells; c += blockDim.x)
    out[c] = use_shadow ? cms_add(static_cast<T>(ist[c]), st[c]) : st[c];
}

// table[l][c] = the sum over p of the partials work[l][p][c], p in order.
template <typename T>
__global__ void cms_reduce(const T* __restrict__ work, T* __restrict__ table,
                           int lanes, int ctas, int cells) {
  const long long n = static_cast<long long>(lanes) * cells;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const long long l = j / cells;
    const T* p = work + l * ctas * cells + (j - l * cells);
    T s = T(0);
    for (int q = 0; q < ctas; ++q) s = cms_add(s, p[static_cast<long long>(q) * cells]);
    table[j] = s;
  }
}

// The entry-order walk (see the header): grid (rows, lanes),
// CMS_F16_THREADS threads. ``staged``: the row is built in shared memory
// and written out once; else it is built in the output, which the caller
// has zeroed (f16), or which the walk zeroes (f32, over the partial
// build's sums). T is __half (the f16 build, each add rounded to f16) or
// float (each add flushed, --ftz=true). ``go``: null (f16), or the sign
// flags of an f32 build's weights (cms_build_partial): the walk runs only
// when they take both signs (3), and the CTA returns at once otherwise.
__device__ __forceinline__ __half walk_add(__half a, __half b) {
  return __hadd(a, b);
}
__device__ __forceinline__ float walk_add(float a, float b) { return a + b; }

template <typename T>
__global__ void __launch_bounds__(CMS_F16_THREADS)
    cms_build_walk(const uint32_t* __restrict__ keys,
                   const T* __restrict__ weights, T* __restrict__ table,
                   long long shard_len, int rows, int width, uint32_t seed,
                   int family, int staged, const unsigned* __restrict__ go) {
  if (go && *go != 3u) return;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* sk = reinterpret_cast<unsigned long long*>(smem);  // (col << 32) | i
  T* sw = reinterpret_cast<T*>(sk + CMS_F16_CHUNK);
  T* st = sw + CMS_F16_CHUNK;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.y) * shard_len;
  T* out = table + (static_cast<long long>(blockIdx.y) * rows + r) * width;
  T* row = staged ? st : out;
  if (staged || go)
    for (int c = t; c < width; c += CMS_F16_THREADS) row[c] = T(0.0f);
  const uint32_t wmask = (width & (width - 1)) == 0 ? width - 1 : 0u;
  const unsigned long long none = ~0ull;  // padding and dropped probes
  for (long long c0 = 0; c0 < shard_len; c0 += CMS_F16_CHUNK) {
    const int n = static_cast<int>(min(static_cast<long long>(CMS_F16_CHUNK),
                                       shard_len - c0));
    __syncthreads();  // the last chunk's walk is done with sk, sw and row
    for (int i = t; i < CMS_F16_CHUNK; i += CMS_F16_THREADS) {
      unsigned long long k = none;
      if (i < n) {
        const int col = cms_hash_build(keys[base + c0 + i], r, width, wmask,
                                       seed, family);
        sw[i] = weights[base + c0 + i];
        if (col >= 0)
          k = (static_cast<unsigned long long>(col) << 32) |
              static_cast<unsigned>(i);
      }
      sk[i] = k;
    }
    __syncthreads();
    // bitonic sort of the chunk's keys, ascending
    for (int k = 2; k <= CMS_F16_CHUNK; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < CMS_F16_CHUNK / 2; i += CMS_F16_THREADS) {
          const int lo = 2 * i - (i & (j - 1));
          const int hi = lo + j;
          const unsigned long long a = sk[lo];
          const unsigned long long b = sk[hi];
          if ((a > b) == ((lo & k) == 0)) {
            sk[lo] = b;
            sk[hi] = a;
          }
        }
        __syncthreads();
      }
    // the first entry of each column's run adds the run, in entry order
    for (int i = t; i < n; i += CMS_F16_THREADS) {
      const unsigned long long k = sk[i];
      if (k == none) continue;
      const unsigned col = static_cast<unsigned>(k >> 32);
      if (i > 0 && static_cast<unsigned>(sk[i - 1] >> 32) == col) continue;
      T acc = row[col];
      for (int j = i; j < n && static_cast<unsigned>(sk[j] >> 32) == col; ++j)
        acc = walk_add(acc, sw[static_cast<unsigned>(sk[j])]);
      row[col] = acc;
    }
  }
  if (!staged) return;
  __syncthreads();
  for (int c = t; c < width; c += CMS_F16_THREADS) out[c] = row[c];
}

// The Pallas order of an f32 build of the kernels' family (ROADMAP Queue 3
// A29; kernels/cms_sketch.py, pallas_f32_build, is the same walk in torch):
// grid (rows, lanes), CMS_BB_THREADS threads, one CTA a (row, lane). The
// lane's keys go in blocks of ``block`` (the last may be shorter); a
// block's sum of each counter is XLA's CPU reduction of the block's one-hot
// products: windows of 32 (the first short by the front pads, cms_bb_win),
// each summed in order from +0, then the window sums in order from +0
// (a block of 32 keys or fewer: XLA's fused loop, cms_short_sum, A30);
// the table adds each block's sum in block order. Every add flushes
// (--ftz=true). A key that misses a counter adds +0, which only turns a
// sum of -0 into +0, so a block is sorted by (column, position) in shared
// memory (bitonic), and the first entry of each column's run walks the
// run's hits: a +0 goes first where a miss comes between two hits, after
// the last hit of a window, or where a window or a block without a hit
// comes between (``last``: each counter's last block with a hit). The row
// and ``last`` live in shared memory when they fit, else in the output and
// in ``glast`` (rows * lanes * width ints of workspace). ``go``: the sign
// flags of the partial build; the walk runs only when the weights take
// both signs (3). Its chain: the blocks of a lane, each a sort of the
// block and its hottest column's run.
#define CMS_BB_THREADS 256
#define CMS_BB_MAX 1024  // the largest block (the sort's keys)

// The windows and front pads of XLA's sum of n values (n <= 1024).
__device__ __forceinline__ void cms_bb_win(int n, int* nwin, int* front) {
  if (n <= 32) {
    *nwin = 1;
    *front = 0;
  } else {
    *nwin = (n + 31) >> 5;
    *front = ((*nwin << 5) - n) >> 1;
  }
}

// A sum of -0 after an add of +0 reads +0.
__device__ __forceinline__ float cms_bb_plus0(float a, bool add) {
  return add && a == 0.0f ? 0.0f : a;
}

// A block of at most 32 keys is XLA's fused loop, whose order LLVM picks
// (ROADMAP Queue 3 A30; cms_sketch.short_block_order says what each order
// is): (VF, UF, epi) by the block, the width and the row (row 0 is a
// fusion of its own).
__device__ __forceinline__ void cms_short_order(int block, int width, int r,
                                                int* vf, int* uf, int* epi) {
  const bool p2 = (width & (width - 1)) == 0;
  const int from = r == 0 ? (p2 ? 22 : 15) : (p2 ? 20 : 14);
  *vf = 8;
  *uf = 1;
  *epi = 1;
  if (width == 1 || block < from) {
    *vf = 1;
  } else if (block < 16) {
    *epi = 0;
  } else if (block >= 20 && block < 24) {
    *vf = 4;
    *uf = 4;
    *epi = 2;
  }
}

// The halving tree of n (a power of two, <= 8) lanes.
__device__ __forceinline__ float cms_halve(float* v, int n) {
  for (int h = n >> 1; h > 0; h >>= 1)
    for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
  return v[0];
}

// A counter's sum over a block of B <= 32 one-hot products x (a miss +0,
// the first already added to +0) in the order (vf, uf, epi); a lane that
// takes no key holds -0.
__device__ float cms_short_sum(const float* x, int B, int vf, int uf,
                               int epi) {
  if (vf == 1) {
    float a = x[0];
    for (int i = 1; i < B; ++i) a = __fadd_rn(a, x[i]);
    return a;
  }
  float acc[4][8];
  unsigned has[4] = {0u, 0u, 0u, 0u};
  for (int u = 0; u < 4; ++u)
    for (int l = 0; l < 8; ++l) acc[u][l] = -0.0f;
  const int step = vf * uf;
  const int main = epi == 0 ? (B + step - 1) / step * step : B / step * step;
  const int lim = min(main, B);
  for (int i = 0; i < lim; ++i) {
    const int u = (i / vf) % uf, l = i % vf;
    acc[u][l] = (has[u] >> l) & 1u ? __fadd_rn(acc[u][l], x[i]) : x[i];
    has[u] |= 1u << l;
  }
  float lanes[8];
  for (int l = 0; l < vf; ++l) lanes[l] = acc[0][l];
  for (int u = 1; u < uf; ++u)
    for (int l = 0; l < vf; ++l) lanes[l] = __fadd_rn(acc[u][l], lanes[l]);
  float s = cms_halve(lanes, vf);
  int i = lim;
  if (epi > 1 && B - i >= epi) {
    float v[8];
    unsigned got = 1u;
    v[0] = s;
    for (int k = 1; k < epi; ++k) v[k] = -0.0f;
    for (; B - i >= epi; i += epi)
      for (int k = 0; k < epi; ++k) {
        v[k] = (got >> k) & 1u ? __fadd_rn(v[k], x[i + k]) : x[i + k];
        got |= 1u << k;
      }
    s = cms_halve(v, epi);
  }
  for (; i < B; ++i) s = __fadd_rn(s, x[i]);
  return s;
}

__global__ void __launch_bounds__(CMS_BB_THREADS)
    cms_build_blocks(const uint32_t* __restrict__ keys,
                     const float* __restrict__ weights,
                     float* __restrict__ table, int* __restrict__ glast,
                     long long shard_len, int rows, int width, uint32_t seed,
                     int family, int block, int staged,
                     const unsigned* __restrict__ go) {
  if (*go != 3u) return;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* sk = reinterpret_cast<unsigned long long*>(smem);  // (col << 32) | i
  float* sw = reinterpret_cast<float*>(sk + CMS_BB_MAX);
  float* srow = sw + CMS_BB_MAX;
  int* slast = reinterpret_cast<int*>(srow + (staged ? width : 0));
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.y) * shard_len;
  const long long cell0 = (static_cast<long long>(blockIdx.y) * rows + r) * width;
  float* row = staged ? srow : table + cell0;
  int* last = staged ? slast : glast + cell0;
  for (int c = t; c < width; c += CMS_BB_THREADS) {
    row[c] = 0.0f;
    last[c] = -1;
  }
  const uint32_t wmask = (width & (width - 1)) == 0 ? width - 1 : 0u;
  const unsigned long long none = ~0ull;  // padding and dropped probes
  const long long nbl = (shard_len + block - 1) / block;
  int vf, uf, epi;
  cms_short_order(block, width, r, &vf, &uf, &epi);
  for (long long b = 0; b < nbl; ++b) {
    const long long c0 = b * block;
    const int n = static_cast<int>(min(static_cast<long long>(block),
                                       shard_len - c0));
    int np = 1;
    while (np < n) np <<= 1;
    __syncthreads();  // the last block's walk is done with sk, sw and row
    for (int i = t; i < np; i += CMS_BB_THREADS) {
      unsigned long long k = none;
      if (i < n) {
        const int col = cms_hash_build(keys[base + c0 + i], r, width, wmask,
                                       seed, family);
        sw[i] = weights[base + c0 + i];
        if (col >= 0)
          k = (static_cast<unsigned long long>(col) << 32) |
              static_cast<unsigned>(i);
      }
      sk[i] = k;
    }
    __syncthreads();
    for (int k = 2; k <= np; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < np / 2; i += CMS_BB_THREADS) {
          const int lo = 2 * i - (i & (j - 1));
          const int hi = lo + j;
          const unsigned long long a = sk[lo];
          const unsigned long long bb = sk[hi];
          if ((a > bb) == ((lo & k) == 0)) {
            sk[lo] = bb;
            sk[hi] = a;
          }
        }
        __syncthreads();
      }
    int nwin, front;
    cms_bb_win(n, &nwin, &front);
    for (int i = t; i < n; i += CMS_BB_THREADS) {
      const unsigned long long k = sk[i];
      if (k == none) continue;
      const unsigned col = static_cast<unsigned>(k >> 32);
      if (i > 0 && static_cast<unsigned>(sk[i - 1] >> 32) == col) continue;
      if (block <= 32) {
        // the fused loop's order over the whole block (a short last block
        // is padded with +0, as the ops entry point pads it)
        float x[32];
        for (int p = 0; p < 32; ++p) x[p] = 0.0f;
        for (int j = i; j < n && static_cast<unsigned>(sk[j] >> 32) == col;
             ++j) {
          const int p = static_cast<int>(static_cast<unsigned>(sk[j]));
          x[p] = sw[p];
        }
        x[0] = __fadd_rn(x[0], 0.0f);
        const float bsum = cms_short_sum(x, block, vf, uf, epi);
        row[col] = cms_bb_plus0(row[col], b > last[col] + 1) + bsum;
        last[col] = static_cast<int>(b);
        continue;
      }
      float acc = 0.0f, bsum = 0.0f;
      int q = -1, prev = -1, wend = 0, prevq = -1;
      for (int j = i; j < n && static_cast<unsigned>(sk[j] >> 32) == col; ++j) {
        const int p = static_cast<int>(static_cast<unsigned>(sk[j]));
        const int qj = (p + front) >> 5;
        if (qj != q) {
          if (q >= 0) {  // close window q into the block's sum
            acc = cms_bb_plus0(acc, prev < wend - 1);
            bsum = cms_bb_plus0(bsum, q > prevq + 1) + acc;
            prevq = q;
          }
          q = qj;
          acc = 0.0f;
          prev = max(0, 32 * q - front) - 1;
          wend = min(n, 32 * (q + 1) - front);
        }
        acc = cms_bb_plus0(acc, p > prev + 1) + sw[p];
        prev = p;
      }
      acc = cms_bb_plus0(acc, prev < wend - 1);
      bsum = cms_bb_plus0(bsum, q > prevq + 1) + acc;
      bsum = cms_bb_plus0(bsum, q < nwin - 1);
      row[col] = cms_bb_plus0(row[col], b > last[col] + 1) + bsum;
      last[col] = static_cast<int>(b);
    }
  }
  __syncthreads();
  for (int c = t; c < width; c += CMS_BB_THREADS) {
    const float v = cms_bb_plus0(row[c], last[c] < nbl - 1);
    if (staged)
      table[cell0 + c] = v;
    else
      row[c] = v;
  }
}

// Shared memory of the block-order walk: the sort's keys and weights, and
// the row and its last blocks when they fit beside them.
size_t cms_blocks_smem(int width, bool* staged) {
  const size_t chunk = CMS_BB_MAX * (sizeof(unsigned long long) + 4);
  *staged = chunk + static_cast<size_t>(width) * 8 <= CHEETAH_MAX_SMEM;
  return chunk + (*staged ? static_cast<size_t>(width) * 8 : 0);
}

// T is the query's type: float, int (a signed minimum) or unsigned.
// kSigned: family 2, whose probe of -1 reads 0; families 0 and 1 take the
// loop of the first port as it was.
template <typename T, bool kSigned>
__global__ void cms_query_kernel(const T* __restrict__ table,
                                 const uint32_t* __restrict__ keys,
                                 T* __restrict__ est, uint8_t* __restrict__ keep,
                                 long long m, int rows, int width,
                                 uint32_t seed, int family, long long thr_i,
                                 float thr_f) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const uint32_t key = keys[i];
    T e;
    if constexpr (kSigned) {
      e = T(0);
      for (int r = 0; r < rows; ++r) {
        const int c = cheetah_hash_mod_i32(
            key, width, seed + 101u * static_cast<uint32_t>(r));
        const T v = c >= 0 ? __ldg(table + r * width + c) : T(0);
        e = r == 0 || v < e ? v : e;
      }
    } else {
      e = __ldg(table + cms_hash(key, 0, width, seed, family));
      for (int r = 1; r < rows; ++r) {
        const T v =
            __ldg(table + r * width + cms_hash(key, r, width, seed, family));
        e = v < e ? v : e;
      }
    }
    if (est) est[i] = e;
    if (keep) {
      if constexpr (std::is_integral<T>::value)
        keep[i] = static_cast<long long>(e) > thr_i;
      else
        keep[i] = e > thr_f;
    }
  }
}

template <typename T>
void query_launch(const void* table, const uint32_t* keys, void* est,
                  uint8_t* keep, long long m, int rows, int width,
                  uint32_t seed, int family, long long thr_i, float thr_f,
                  int grid, cudaStream_t stream) {
  auto t = static_cast<const T*>(table);
  auto e = static_cast<T*>(est);
  if (family == 2)
    cms_query_kernel<T, true><<<grid, 256, 0, stream>>>(
        t, keys, e, keep, m, rows, width, seed, family, thr_i, thr_f);
  else
    cms_query_kernel<T, false><<<grid, 256, 0, stream>>>(
        t, keys, e, keep, m, rows, width, seed, family, thr_i, thr_f);
}

// The persistent query (see the header; the scaffolding is query.cuh's):
// grid of query_ctas CTAs of QUERY_THREADS threads. kStaged: the table is
// copied into shared memory once a CTA, with 16-byte copies where it is
// 16-byte aligned, and gathered from there; else gathered from global
// memory (a table above the shared-memory budget). ROWS > 0 unrolls the
// rows (the main path's 3); 0 takes ``rows`` at run time. kPow2: a width
// that is a power of two (query.cuh).
//
// Reads (T float): the kernels' family (FAM 0, 2) reads as the Pallas
// query's one-hot product sum_c onehot[c] * T[r][c] (kOnehot): row r's read
// of column c is NaN when another counter of row r is not finite (0 * inf)
// or T[r][c] is NaN, else T[r][c] + 0.0 with subnormals flushed, so -0
// reads +0; a dropped probe reads +0, or NaN in a row with a non-finite
// counter. The estimate is the NaN-propagating minimum of float32(3.4e38),
// the reference's start value, and the reads. ``nf`` counts each row's
// non-finite counters: the staged form counts them as it copies the table,
// the global one is handed them (cms_row_nonfinite); while no row has one,
// each read is only the flush. The engine's family reads the counters as
// jnp.min takes them: subnormals flushed (not with one row, which XLA
// reads as a copy), a NaN of any row wins, -0 below +0. A threshold
// compares the flushed estimate with the flushed threshold (the wrapper
// flushes it). Integer tables: the signed or unsigned minimum, a dropped
// probe reading 0.
// e folded with v as XLA's minimum: v wins when lower, when NaN, or as a
// -0 against a +0; a NaN e stays.
__device__ __forceinline__ float cms_min(float e, float v) {
  return (v < e || v != v || (v == e && signbit(v))) ? v : e;
}

// The same where no -0 comes in (the one-hot reads): one min.NaN, whose NaN
// wins.
__device__ __forceinline__ float cms_min_nan(float e, float v) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(e), "f"(v));
  return r;
}

// v + 0.0 with subnormals flushed (one add.ftz): -0 and the subnormals of
// either sign read +0.
__device__ __forceinline__ float cms_plus_zero(float v) {
  float r;
  asm("add.ftz.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T, bool kStaged>
__device__ __forceinline__ T cms_load(const T* tab, int i) {
  if constexpr (kStaged)
    return tab[i];
  else
    return __ldg(tab + i);
}

// Row r of a key folded into its estimate e (R rows in all).
template <typename T, int FAM, bool kPow2, bool kStaged, bool kRule>
__device__ __forceinline__ void cms_fold(T& e, uint32_t key, int r,
                                         const T* tab, const int* nf, int R,
                                         int width, uint32_t seed,
                                         const QueryHash& q) {
  const int c =
      static_cast<int>(query_column<FAM, kPow2>(key, query_seed<FAM>(seed, r),
                                                q));
  const T v = FAM != 2 || c >= 0 ? cms_load<T, kStaged>(tab, r * width + c)
                                 : T(0);
  if constexpr (std::is_same<T, float>::value && FAM != 1) {
    float rd = cms_plus_zero(v);
    if (kRule) {
      const int n = nf[r];
      if (!(n == 0 || (n == 1 && c >= 0 && isinf(v))))
        rd = __int_as_float(0x7FC00000);
    }
    e = cms_min_nan(e, rd);
  } else if constexpr (std::is_same<T, float>::value) {
    const float rd = R > 1 ? cheetah_ftz(v) : v;
    e = r == 0 ? rd : cms_min(e, rd);
  } else {
    e = r == 0 || v < e ? v : e;
  }
}

template <typename T, int FAM, int ROWS, bool kPow2, bool kStaged,
          bool kRule>
__device__ __forceinline__ T cms_estimate(uint32_t key, const T* tab,
                                          const int* nf, int rows, int width,
                                          uint32_t seed, const QueryHash& q) {
  T e = T(0);
  if constexpr (std::is_same<T, float>::value && FAM != 1)
    e = __uint_as_float(0x7F7FC99Eu);  // float32(3.4e38)
  if constexpr (ROWS > 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      cms_fold<T, FAM, kPow2, kStaged, kRule>(e, key, r, tab, nf, ROWS,
                                              width, seed, q);
  } else {
    for (int r = 0; r < rows; ++r)
      cms_fold<T, FAM, kPow2, kStaged, kRule>(e, key, r, tab, nf, rows,
                                              width, seed, q);
  }
  return e;
}

template <typename T>
__device__ __forceinline__ uint8_t cms_keep(T e, long long thr_i,
                                            float thr_f) {
  if constexpr (std::is_same<T, float>::value)
    return cheetah_ftz(e) > thr_f;
  else
    return static_cast<long long>(e) > thr_i;
}

template <typename T, int FAM, int ROWS, bool kPow2, bool kStaged,
          bool kRule>
__device__ __forceinline__ void cms_query_loop(
    const uint32_t* __restrict__ keys, T* __restrict__ est,
    uint8_t* __restrict__ keep, long long m, const T* tab, const int* nf,
    int rows, int width, uint32_t seed, const QueryHash& q, long long thr_i,
    float thr_f, int vec_out) {
  using V = typename std::conditional<std::is_same<T, float>::value, float4,
                                      uint4>::type;
  const QuerySpan sp = query_span(keys, m);
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the head and the tail (at most 3 keys each), a key a thread
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const long long i = part == 0 ? (g < sp.head ? g : m) : sp.body_end + g;
    if (i >= m) continue;
    const T e = cms_estimate<T, FAM, ROWS, kPow2, kStaged, kRule>(
        __ldg(keys + i), tab, nf, rows, width, seed, q);
    if (est) est[i] = e;
    if (keep) keep[i] = cms_keep(e, thr_i, thr_f);
  }
  const uint4* kv = reinterpret_cast<const uint4*>(keys + sp.head);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x *
                         QUERY_UNITS;
  for (long long u0 = static_cast<long long>(blockIdx.x) * blockDim.x *
                          QUERY_UNITS + threadIdx.x;
       u0 < sp.units; u0 += step) {
    uint4 k[QUERY_UNITS];
#pragma unroll
    for (int j = 0; j < QUERY_UNITS; ++j) {
      const long long u = u0 + static_cast<long long>(j) * blockDim.x;
      k[j] = u < sp.units ? __ldcs(kv + u) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < QUERY_UNITS; ++j) {
      const long long u = u0 + static_cast<long long>(j) * blockDim.x;
      if (u >= sp.units) break;
      T e[4];
      e[0] = cms_estimate<T, FAM, ROWS, kPow2, kStaged, kRule>(k[j].x, tab, nf, rows,
                                                       width, seed, q);
      e[1] = cms_estimate<T, FAM, ROWS, kPow2, kStaged, kRule>(k[j].y, tab, nf, rows,
                                                       width, seed, q);
      e[2] = cms_estimate<T, FAM, ROWS, kPow2, kStaged, kRule>(k[j].z, tab, nf, rows,
                                                       width, seed, q);
      e[3] = cms_estimate<T, FAM, ROWS, kPow2, kStaged, kRule>(k[j].w, tab, nf, rows,
                                                       width, seed, q);
      const long long i = sp.head + 4 * u;
      if (est) {
        if (vec_out) {
          V v;
          memcpy(&v, e, 16);
          __stcs(reinterpret_cast<V*>(est + sp.head) + u, v);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) est[i + t] = e[t];
        }
      }
      if (keep) {
        uint8_t b[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) b[t] = cms_keep(e[t], thr_i, thr_f);
        if (vec_out) {
          uint32_t w;
          memcpy(&w, b, 4);
          __stcs(reinterpret_cast<unsigned*>(keep + sp.head) + u, w);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) keep[i + t] = b[t];
        }
      }
    }
  }
}

template <typename T, int FAM, int ROWS, bool kStaged, bool kPow2>
__global__ void __launch_bounds__(QUERY_THREADS)
    cms_query_persistent(const T* __restrict__ table,
                         const uint32_t* __restrict__ keys,
                         T* __restrict__ est, uint8_t* __restrict__ keep,
                         long long m, int rows, int width, uint32_t seed,
                         QueryHash q, long long thr_i, float thr_f,
                         const int* __restrict__ nf_rows, int vec_out) {
  constexpr bool kOnehot = std::is_same<T, float>::value && FAM != 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int* nf = reinterpret_cast<int*>(smem);  // [rows]: non-finite counters
  T* st = reinterpret_cast<T*>(smem + ((rows * 4 + 15) & ~15));
  const int tid = threadIdx.x;
  if (kOnehot)
    for (int r = tid; r < rows; r += blockDim.x)
      nf[r] = kStaged ? 0 : nf_rows[r];
  if (kStaged) {
    __syncthreads();
    const int cells = rows * width;
    int vec = 0;
    if ((reinterpret_cast<uintptr_t>(table) & 15) == 0) {
      vec = cells >> 2;
      const uint4* src = reinterpret_cast<const uint4*>(table);
      uint4* dst = reinterpret_cast<uint4*>(st);
      for (int v = tid; v < vec; v += blockDim.x) {
        const uint4 x = __ldg(src + v);
        dst[v] = x;
        if (kOnehot) {
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (!isfinite(__uint_as_float(w[t])))
              atomicAdd(nf + (4 * v + t) / width, 1);
        }
      }
      vec *= 4;
    }
    for (int c = vec + tid; c < cells; c += blockDim.x) {
      const T x = __ldg(table + c);
      st[c] = x;
      if (kOnehot && !isfinite(static_cast<float>(x))) atomicAdd(nf + c / width, 1);
    }
  }
  __syncthreads();
  const T* tab = kStaged ? st : table;
  bool rule = false;
  if (kOnehot)
    for (int r = 0; r < rows; ++r) rule |= nf[r] != 0;
  if (rule)
    cms_query_loop<T, FAM, ROWS, kPow2, kStaged, true>(keys, est, keep, m, tab, nf,
                                                rows, width, seed, q, thr_i,
                                                thr_f, vec_out);
  else
    cms_query_loop<T, FAM, ROWS, kPow2, kStaged, false>(keys, est, keep, m, tab, nf,
                                                 rows, width, seed, q, thr_i,
                                                 thr_f, vec_out);
}

// nf[r] = the non-finite counters of row r of an f32 table: one CTA a row,
// before the global form's query of the kernels' family.
__global__ void cms_row_nonfinite(const float* __restrict__ table, int width,
                                  int* __restrict__ nf) {
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const float* row = table + static_cast<long long>(blockIdx.x) * width;
  int n = 0;
  for (int c = threadIdx.x; c < width; c += blockDim.x)
    n += !isfinite(__ldg(row + c));
  if (n) atomicAdd(&count, n);
  __syncthreads();
  if (threadIdx.x == 0) nf[blockIdx.x] = count;
}

// Shared memory of the staged query: the rows' counts and the table.
size_t cmsq_smem(int rows, int width) {
  return ((static_cast<size_t>(rows) * 4 + 15) & ~size_t(15)) +
         static_cast<size_t>(rows) * width * 4;
}

// The route, here alone: a table whose staged form fits a CTA's shared
// memory is staged.
bool cmsq_staged(int rows, int width) {
  return cmsq_smem(rows, width) <= CHEETAH_MAX_SMEM;
}

// The instantiations: staged with the main path's 3 rows unrolled or any
// rows at run time, or gathered from global memory; a power-of-two width
// or not.
template <typename T, int FAM, bool kPow2>
const void* cmsq_kernel(int rows, bool staged) {
  if (!staged)
    return reinterpret_cast<const void*>(
        cms_query_persistent<T, FAM, 0, false, kPow2>);
  if (rows == 3)
    return reinterpret_cast<const void*>(
        cms_query_persistent<T, FAM, 3, true, kPow2>);
  return reinterpret_cast<const void*>(
      cms_query_persistent<T, FAM, 0, true, kPow2>);
}

template <typename T>
const void* cmsq_kernel_t(int family, int rows, bool staged, bool pow2) {
  if (family == 1)
    return pow2 ? cmsq_kernel<T, 1, true>(rows, staged)
                : cmsq_kernel<T, 1, false>(rows, staged);
  if (family == 2)
    return pow2 ? cmsq_kernel<T, 2, true>(rows, staged)
                : cmsq_kernel<T, 2, false>(rows, staged);
  return pow2 ? cmsq_kernel<T, 0, true>(rows, staged)
              : cmsq_kernel<T, 0, false>(rows, staged);
}

// The instantiation a query launches: ttype 0 f32, 1 int32, 2 uint32.
const void* cmsq_pick(int ttype, int family, int rows, bool staged,
                      bool pow2) {
  if (ttype == 1) return cmsq_kernel_t<int>(family, rows, staged, pow2);
  if (ttype == 2) return cmsq_kernel_t<unsigned>(family, rows, staged, pow2);
  return cmsq_kernel_t<float>(family, rows, staged, pow2);
}

size_t cms_table_bytes(int rows, int width) {
  return static_cast<size_t>(rows) * width * 4;
}

// The build's layout for lanes of shard_len keys: ``ctas`` a lane, the
// int32 shadow's limit (0: none), the shared memory a CTA and the
// workspace's bytes of the partials.
struct CmsPlan {
  int ctas;
  float shadow;
  size_t smem;
  size_t work;
};

// The largest integer-valued f32 weight the int32 shadow takes at ``ctas``
// CTAs a lane: a power of two small enough that no CTA's partial counter
// can pass 2^31 - 1 (a CTA adds at most one weight a key to a counter), at
// most 2^24; 0 when not even 1 is.
float cms_shadow_limit(long long shard_len, int ctas) {
  const long long per_round = static_cast<long long>(CMS_THREADS) * CMS_UNROLL;
  const long long rounds = (shard_len + per_round - 1) / per_round;
  const long long keys = (rounds + ctas - 1) / ctas * per_round;
  long long limit = 0x7FFFFFFFLL / (keys > 0 ? keys : 1);
  if (limit < 1) return 0.0f;
  long long p = 1;
  while (p * 2 <= limit && p < (1LL << 24)) p *= 2;
  return static_cast<float>(p);
}

cudaError_t cms_plan(int lanes, long long shard_len, int rows, int width,
                     int is_int, CmsPlan* plan) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const size_t bytes = cms_table_bytes(rows, width);
  const bool staged = bytes <= CHEETAH_MAX_SMEM;
  // an f32 table keeps the int32 shadow where both fit
  const bool shadow = staged && !is_int && 2 * bytes <= CHEETAH_MAX_SMEM;
  plan->smem = staged ? (shadow ? 2 * bytes : bytes) : 0;
  const int per_sm = plan->smem <= 110 * 1024 ? 2 : 1;
  const long long per_round = static_cast<long long>(CMS_THREADS) * CMS_UNROLL;
  const long long rounds = (shard_len + per_round - 1) / per_round;
  long long ctas =
      static_cast<long long>(per_sm) * sms / (lanes > 0 ? lanes : 1);
  if (ctas > rounds) ctas = rounds;
  plan->ctas = static_cast<int>(ctas < 1 ? 1 : ctas);
  plan->shadow = shadow ? cms_shadow_limit(shard_len, plan->ctas) : 0.0f;
  plan->work = staged && plan->ctas > 1
                   ? static_cast<size_t>(lanes) * plan->ctas * bytes
                   : 0;
  return cudaSuccess;
}

template <typename T>
cudaError_t atomic_launch(const uint32_t* keys, const void* weights,
                          void* table, int lanes, int shard_len, int rows,
                          int width, uint32_t seed, int family,
                          int ctas_per_lane, cudaStream_t stream) {
  const size_t bytes = cms_table_bytes(rows, width);
  const int staged = bytes <= 200 * 1024;
  const size_t smem = staged ? bytes : 0;
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(cms_build_atomic_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  const int per_cta = (shard_len + ctas_per_lane - 1) / ctas_per_lane;
  cms_build_atomic_kernel<T><<<dim3(ctas_per_lane, lanes), 256, smem, stream>>>(
      keys, static_cast<const T*>(weights), static_cast<T*>(table), shard_len,
      rows, width, seed, family, per_cta, staged);
  return cudaGetLastError();
}

template <typename T, int kWeights>
cudaError_t partial_launch(const uint32_t* keys, const void* weights,
                           void* table, void* work, int lanes,
                           long long shard_len, int rows, int width,
                           uint32_t seed, int family, const CmsPlan& plan,
                           unsigned* signs, cudaStream_t stream) {
  const int staged = cms_table_bytes(rows, width) <= CHEETAH_MAX_SMEM;
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(cms_build_partial<T, kWeights>),
      plan.smem);
  if (err != cudaSuccess) return err;
  cms_build_partial<T, kWeights>
      <<<dim3(plan.ctas, lanes), CMS_THREADS, plan.smem, stream>>>(
          keys, static_cast<const T*>(weights), static_cast<T*>(table),
          static_cast<T*>(work), shard_len, rows, width, seed, family, staged,
          plan.shadow, signs);
  err = cudaGetLastError();
  if (err != cudaSuccess || !staged || plan.ctas == 1) return err;
  const int cells = rows * width;
  const long long n = static_cast<long long>(lanes) * cells;
  const unsigned grid = static_cast<unsigned>(min((n + 255) / 256, 132LL * 16));
  cms_reduce<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(work),
                                          static_cast<T*>(table), lanes,
                                          plan.ctas, cells);
  return cudaGetLastError();
}

template <typename T>
cudaError_t build_launch(const uint32_t* keys, const void* weights,
                         void* table, void* work, int lanes,
                         long long shard_len, int rows, int width,
                         uint32_t seed, int family, const CmsPlan& plan,
                         unsigned* signs, cudaStream_t stream) {
  if (weights)
    return partial_launch<T, 1>(keys, weights, table, work, lanes, shard_len,
                                rows, width, seed, family, plan, signs,
                                stream);
  return partial_launch<T, 0>(keys, weights, table, work, lanes, shard_len,
                              rows, width, seed, family, plan, nullptr,
                              stream);
}

// Shared memory of the entry-order walk: the chunk's sort keys and weights,
// and the row when it fits beside them (else 0 for the row).
size_t cms_walk_smem(int width, size_t tsize, bool* staged) {
  const size_t chunk = CMS_F16_CHUNK * (sizeof(unsigned long long) + tsize);
  *staged = chunk + static_cast<size_t>(width) * tsize <= CHEETAH_MAX_SMEM;
  return chunk + (*staged ? static_cast<size_t>(width) * tsize : 0);
}

cudaError_t blocks_launch(const uint32_t* keys, const void* weights,
                          void* table, int* glast, int lanes,
                          long long shard_len, int rows, int width,
                          uint32_t seed, int family, int block,
                          const unsigned* go, cudaStream_t stream) {
  if (!weights || block < 1 || block > CMS_BB_MAX) return cudaErrorInvalidValue;
  bool staged;
  const size_t smem = cms_blocks_smem(width, &staged);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(cms_build_blocks), smem);
  if (err != cudaSuccess) return err;
  cms_build_blocks<<<dim3(rows, lanes), CMS_BB_THREADS, smem, stream>>>(
      keys, static_cast<const float*>(weights), static_cast<float*>(table),
      glast, shard_len, rows, width, seed, family, block, staged, go);
  return cudaGetLastError();
}

template <typename T>
cudaError_t walk_launch(const uint32_t* keys, const void* weights,
                        void* table, int lanes, long long shard_len, int rows,
                        int width, uint32_t seed, int family,
                        const unsigned* go, cudaStream_t stream) {
  if (!weights) return cudaErrorInvalidValue;
  bool staged;
  const size_t smem = cms_walk_smem(width, sizeof(T), &staged);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(cms_build_walk<T>), smem);
  if (err != cudaSuccess) return err;
  cms_build_walk<T><<<dim3(rows, lanes), CMS_F16_THREADS, smem, stream>>>(
      keys, static_cast<const T*>(weights), static_cast<T*>(table),
      shard_len, rows, width, seed, family, staged, go);
  return cudaGetLastError();
}

}  // namespace

// The build's layout on the current device: out = {CTAs a lane, the int32
// shadow's limit, the workspace's bytes} (see cms_plan).
extern "C" int cms_build_plan(int lanes, long long shard_len, int rows,
                              int width, int is_int, long long* out) {
  CmsPlan plan;
  const cudaError_t err = cms_plan(lanes, shard_len, rows, width, is_int,
                                   &plan);
  if (err != cudaSuccess) return err;
  out[0] = plan.ctas;
  out[1] = static_cast<long long>(plan.shadow);
  out[2] = static_cast<long long>(plan.work);
  return cudaSuccess;
}

// The output table: written whole where the table is staged in shared
// memory, else added into (the caller zeroes it first). ``work`` holds
// cms_build_plan's workspace bytes rounded up to 16, and 16 bytes more for
// an f32 build's sign flags, and for the kernels' family (family != 1)
// lanes * rows * width ints more (cms_build_blocks' last blocks). ttype: 0
// f32, 1 int32, 2 f16 (the f16 walk, which takes no workspace). An f32
// build with weights runs the partial build, which also flags the signs
// its weights take, then a walk, which returns at once unless they take
// both (ROADMAP Queue 3 A28: such a cell's sums can pass below FLT_MIN,
// where each add flushes, so they must come in the reference's order) and
// else builds the whole table again: in entry order for the engine's
// family, by blocks of ``block`` keys in XLA's order for the kernels'
// (A29, cms_build_blocks).
extern "C" int cms_build(const uint32_t* keys, const void* weights,
                         void* table, void* work, int lanes,
                         long long shard_len, int rows, int width,
                         uint32_t seed, int family, int ttype, int block,
                         cudaStream_t stream) {
  if (ttype == 2)
    return walk_launch<__half>(keys, weights, table, lanes, shard_len, rows,
                               width, seed, family, nullptr, stream);
  const int is_int = ttype;
  CmsPlan plan;
  cudaError_t err = cms_plan(lanes, shard_len, rows, width, is_int, &plan);
  if (err != cudaSuccess) return err;
  if (is_int)
    return build_launch<int>(keys, weights, table, work, lanes, shard_len,
                             rows, width, seed, family, plan, nullptr,
                             stream);
  unsigned* signs = nullptr;
  if (weights) {
    signs = reinterpret_cast<unsigned*>(static_cast<unsigned char*>(work) +
                                        ((plan.work + 15) & ~size_t(15)));
    err = cudaMemsetAsync(signs, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
  }
  err = build_launch<float>(keys, weights, table, work, lanes, shard_len,
                            rows, width, seed, family, plan, signs, stream);
  if (err != cudaSuccess || !weights) return err;
  if (family != 1)
    return blocks_launch(keys, weights, table,
                         reinterpret_cast<int*>(
                             reinterpret_cast<unsigned char*>(signs) + 16),
                         lanes, shard_len, rows, width, seed, family, block,
                         signs, stream);
  return walk_launch<float>(keys, weights, table, lanes, shard_len, rows,
                            width, seed, family, signs, stream);
}

// The retired build, for holding the partial-table build against it;
// launched by no entry point of the package. The table must be zeroed
// first.
extern "C" int cms_build_atomic(const uint32_t* keys, const void* weights,
                                void* table, int lanes, int shard_len,
                                int rows, int width, uint32_t seed,
                                int family, int is_int, int ctas_per_lane,
                                cudaStream_t stream) {
  if (is_int)
    return atomic_launch<int>(keys, weights, table, lanes, shard_len, rows,
                              width, seed, family, ctas_per_lane, stream);
  return atomic_launch<float>(keys, weights, table, lanes, shard_len, rows,
                              width, seed, family, ctas_per_lane, stream);
}

// The retired query (cms_query_kernel: a grid-stride loop, a key a thread
// an iteration, the counters gathered from global memory, the minimum from
// row 0 on with <), for holding the persistent query against it on finite
// tables; launched by no entry point of the package. ttype: 0 f32, 1 int32,
// 2 uint32 (unsigned minima).
extern "C" int cms_query_grid(const void* table, const uint32_t* keys,
                              void* est, uint8_t* keep, long long m, int rows,
                              int width, uint32_t seed, int family, int ttype,
                              long long thr_i, float thr_f, int grid,
                              cudaStream_t stream) {
  if (ttype == 1)
    query_launch<int>(table, keys, est, keep, m, rows, width, seed, family,
                      thr_i, thr_f, grid, stream);
  else if (ttype == 2)
    query_launch<unsigned>(table, keys, est, keep, m, rows, width, seed,
                           family, thr_i, thr_f, grid, stream);
  else
    query_launch<float>(table, keys, est, keep, m, rows, width, seed, family,
                        thr_i, thr_f, grid, stream);
  return cudaGetLastError();
}

// Shared memory of a query launch: the rows' counts, and the table when it
// is staged.
static size_t cmsq_launch_smem(int rows, int width) {
  return cmsq_staged(rows, width) ? cmsq_smem(rows, width)
                                  : cmsq_smem(rows, 0);
}

// Whether the query first counts each row's non-finite counters into the
// workspace: the global form, an f32 table, the kernels' family.
static bool cmsq_counts_first(int rows, int width, int ttype, int family) {
  return !cmsq_staged(rows, width) && ttype == 0 && family != 1;
}

// The query's plan on the current device, into out[3]: the route (1: the
// table staged in each CTA's shared memory, 0: gathered from global
// memory), the persistent grid's CTAs, and the workspace's bytes.
extern "C" int cms_query_plan(int rows, int width, int ttype, int family,
                              int* out) {
  const bool staged = cmsq_staged(rows, width);
  int ctas = 0;
  const QueryHash q = query_hash(static_cast<uint32_t>(width), family);
  const cudaError_t e =
      query_ctas(cmsq_pick(ttype, family, rows, staged, q.pow2),
                 cmsq_launch_smem(rows, width), &ctas);
  out[0] = staged;
  out[1] = ctas;
  out[2] = cmsq_counts_first(rows, width, ttype, family) ? rows * 4 : 0;
  return e;
}

// The persistent query: est[m] (T, or null) and keep[m] (est > threshold,
// or null) of the keys against table[rows][width]; ttype 0 f32, 1 int32,
// 2 uint32; ``ctas`` from cms_query_plan; ``work`` its workspace.
extern "C" int cms_query(const void* table, const uint32_t* keys, void* est,
                         uint8_t* keep, long long m, int rows, int width,
                         uint32_t seed, int family, int ttype,
                         long long thr_i, float thr_f, int ctas, int* work,
                         cudaStream_t stream) {
  if (m < 1) return cudaSuccess;
  const bool staged = cmsq_staged(rows, width);
  const size_t smem = cmsq_launch_smem(rows, width);
  QueryHash q = query_hash(static_cast<uint32_t>(width), family);
  const void* fn = cmsq_pick(ttype, family, rows, staged, q.pow2);
  cudaError_t e = cheetah_launch_prep(fn, smem);
  if (e != cudaSuccess) return e;
  const int* nf = nullptr;
  if (cmsq_counts_first(rows, width, ttype, family)) {
    if (!work) return cudaErrorInvalidValue;
    cms_row_nonfinite<<<rows, 256, 0, stream>>>(
        static_cast<const float*>(table), width, work);
    nf = work;
  }
  int vec_out = est ? query_vector_out(est, 4, keys, m)
                    : query_vector_out(keep, 1, keys, m);
  if (est && keep)
    vec_out = vec_out && query_vector_out(keep, 1, keys, m);
  void* args[] = {&table, &keys, &est,  &keep,  &m,  &rows,   &width,
                  &seed,  &q,    &thr_i, &thr_f, &nf, &vec_out};
  e = cudaLaunchKernel(fn, dim3(query_grid(ctas, keys, m)),
                       dim3(QUERY_THREADS), args, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}
