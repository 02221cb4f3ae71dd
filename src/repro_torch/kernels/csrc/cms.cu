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
// form fuses "estimate > threshold" and writes the keep mask instead.
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
// adds do not associate, so cms_build_f16 is a walk and not a reduction:
// one CTA a (row, lane) takes the lane's keys in chunks of CMS_F16_CHUNK,
// sorts each chunk in shared memory by (column, position) with a bitonic
// network (the position in the key keeps equal columns in entry order),
// and then the first thread of each column's run adds the run in order into
// the row, kept in shared memory when it fits and in the output otherwise.
// Each counter has one writer a chunk and the chunks go in order, so no
// atomics are needed. Its chain is the hottest counter's entries, one
// dependent f16 add each.
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
// reductions a key in 32-bit integer arithmetic.
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hash.cuh"

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
                      float shadow) {
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

// The f16 build (see the header): grid (rows, lanes), CMS_F16_THREADS
// threads. ``staged``: the row is built in shared memory and written out
// once; else it is built in the output, which the caller has zeroed.
__global__ void __launch_bounds__(CMS_F16_THREADS)
    cms_build_f16(const uint32_t* __restrict__ keys,
                  const __half* __restrict__ weights, __half* __restrict__ table,
                  long long shard_len, int rows, int width, uint32_t seed,
                  int family, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* sk = reinterpret_cast<unsigned long long*>(smem);  // (col << 32) | i
  __half* sw = reinterpret_cast<__half*>(sk + CMS_F16_CHUNK);
  __half* st = sw + CMS_F16_CHUNK;
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.y) * shard_len;
  __half* out = table + (static_cast<long long>(blockIdx.y) * rows + r) * width;
  __half* row = staged ? st : out;
  if (staged)
    for (int c = t; c < width; c += CMS_F16_THREADS) row[c] = __float2half(0.0f);
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
      __half acc = row[col];
      for (int j = i; j < n && static_cast<unsigned>(sk[j] >> 32) == col; ++j)
        acc = __hadd(acc, sw[static_cast<unsigned>(sk[j])]);
      row[col] = acc;
    }
  }
  if (!staged) return;
  __syncthreads();
  for (int c = t; c < width; c += CMS_F16_THREADS) out[c] = row[c];
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
                           cudaStream_t stream) {
  const int staged = cms_table_bytes(rows, width) <= CHEETAH_MAX_SMEM;
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(cms_build_partial<T, kWeights>),
      plan.smem);
  if (err != cudaSuccess) return err;
  cms_build_partial<T, kWeights>
      <<<dim3(plan.ctas, lanes), CMS_THREADS, plan.smem, stream>>>(
          keys, static_cast<const T*>(weights), static_cast<T*>(table),
          static_cast<T*>(work), shard_len, rows, width, seed, family, staged,
          plan.shadow);
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
                         cudaStream_t stream) {
  if (weights)
    return partial_launch<T, 1>(keys, weights, table, work, lanes, shard_len,
                                rows, width, seed, family, plan, stream);
  return partial_launch<T, 0>(keys, weights, table, work, lanes, shard_len,
                              rows, width, seed, family, plan, stream);
}

// Shared memory of the f16 build: the chunk's sort keys and weights, and
// the row when it fits beside them (else 0 for the row).
size_t cms_f16_smem(int width, bool* staged) {
  const size_t chunk = CMS_F16_CHUNK * (sizeof(unsigned long long) + 2);
  *staged = chunk + static_cast<size_t>(width) * 2 <= CHEETAH_MAX_SMEM;
  return chunk + (*staged ? static_cast<size_t>(width) * 2 : 0);
}

cudaError_t f16_launch(const uint32_t* keys, const void* weights, void* table,
                       int lanes, long long shard_len, int rows, int width,
                       uint32_t seed, int family, cudaStream_t stream) {
  if (!weights) return cudaErrorInvalidValue;
  bool staged;
  const size_t smem = cms_f16_smem(width, &staged);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(cms_build_f16), smem);
  if (err != cudaSuccess) return err;
  cms_build_f16<<<dim3(rows, lanes), CMS_F16_THREADS, smem, stream>>>(
      keys, static_cast<const __half*>(weights), static_cast<__half*>(table),
      shard_len, rows, width, seed, family, staged);
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
// cms_build_plan's workspace bytes. ttype: 0 f32, 1 int32, 2 f16 (the f16
// build, which takes no workspace).
extern "C" int cms_build(const uint32_t* keys, const void* weights,
                         void* table, void* work, int lanes,
                         long long shard_len, int rows, int width,
                         uint32_t seed, int family, int ttype,
                         cudaStream_t stream) {
  if (ttype == 2)
    return f16_launch(keys, weights, table, lanes, shard_len, rows, width,
                      seed, family, stream);
  const int is_int = ttype;
  CmsPlan plan;
  const cudaError_t err = cms_plan(lanes, shard_len, rows, width, is_int,
                                   &plan);
  if (err != cudaSuccess) return err;
  if (is_int)
    return build_launch<int>(keys, weights, table, work, lanes, shard_len,
                             rows, width, seed, family, plan, stream);
  return build_launch<float>(keys, weights, table, work, lanes, shard_len,
                             rows, width, seed, family, plan, stream);
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

// ttype: 0 f32, 1 int32, 2 uint32 (unsigned minima).
extern "C" int cms_query(const void* table, const uint32_t* keys, void* est,
                         uint8_t* keep, long long m, int rows, int width,
                         uint32_t seed, int family, int ttype,
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
