// Count-Min sketch (paper Ex. 5, HAVING) on Hopper: build and query.
//
// cms_build replaces cms_build_kernel (src/repro/kernels/cms_sketch.py:39)
// and builds the engine's per-lane HAVING sketches (core.sketches.cms_build,
// an XLA scatter-add in the JAX package). A weighted scatter-add of every
// key into rows counters of table[lane][r][hash_r(key)]. The grid is
// (CTAs per lane, lanes); each CTA builds a partial table of its slice of
// the lane in shared memory with shared atomics, then adds its non-zero
// counters to the lane's table with global atomics. A table above the
// shared-memory budget goes straight to global atomics.
//
// cms_query replaces cms_query_kernel (src/repro/kernels/cms_sketch.py:72):
// per key, the minimum over rows of table[r][hash_r(key)]; the engine's
// form fuses "estimate > threshold" and writes the keep mask instead.
//
// Both are templated on the table type (int32 for COUNT and integer SUM,
// which wraps mod 2^32 as the reference's int32 table does; f32 otherwise)
// and take the hash family at run time: family 0 is the Pallas kernels'
// hash_mod(key, width, seed + 101 r), family 1 the engine's
// multi_hash(key, width, rows, seed). Integer sums are exact in any order;
// f32 sums are exact only for integer-valued weights whose sums stay below
// 2^24, and otherwise differ from a sequential sum in the order of adds.
//
// What bounds them: bytes (read the keys and weights once, write the
// estimates or the mask once). The build's shared atomics on a zipf key
// column contend on the hot counters.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hash.cuh"

namespace {

__device__ __forceinline__ int cms_hash(uint32_t key, int r, int width,
                                        uint32_t seed, int family) {
  return family == 0
             ? cheetah_hash_mod(key, width, seed + 101u * static_cast<uint32_t>(r))
             : cheetah_multi_hash(key, width, r, seed);
}

// int32 atomics wrap mod 2^32 like the reference's int32 scatter-add.
template <typename T>
__global__ void cms_build_kernel(const uint32_t* __restrict__ keys,
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
    for (int r = 0; r < rows; ++r)
      atomicAdd(dst + r * width + cms_hash(key, r, width, seed, family), v);
  }
  if (staged) {
    __syncthreads();
    for (int c = threadIdx.x; c < cells; c += blockDim.x)
      if (st[c] != T(0)) atomicAdd(lane_table + c, st[c]);
  }
}

template <typename T>
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
    T e = __ldg(table + cms_hash(key, 0, width, seed, family));
    for (int r = 1; r < rows; ++r) {
      const T v = __ldg(table + r * width + cms_hash(key, r, width, seed, family));
      e = v < e ? v : e;
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
cudaError_t build_launch(const uint32_t* keys, const void* weights,
                         void* table, int lanes, int shard_len, int rows,
                         int width, uint32_t seed, int family,
                         int ctas_per_lane, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(rows) * width * sizeof(T);
  const int staged = bytes <= 200 * 1024;
  const size_t smem = staged ? bytes : 0;
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(cms_build_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  const int per_cta = (shard_len + ctas_per_lane - 1) / ctas_per_lane;
  cms_build_kernel<T><<<dim3(ctas_per_lane, lanes), 256, smem, stream>>>(
      keys, static_cast<const T*>(weights), static_cast<T*>(table), shard_len,
      rows, width, seed, family, per_cta, staged);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cms_build(const uint32_t* keys, const void* weights,
                         void* table, int lanes, int shard_len, int rows,
                         int width, uint32_t seed, int family, int is_int,
                         int ctas_per_lane, cudaStream_t stream) {
  if (is_int)
    return build_launch<int>(keys, weights, table, lanes, shard_len, rows,
                             width, seed, family, ctas_per_lane, stream);
  return build_launch<float>(keys, weights, table, lanes, shard_len, rows,
                             width, seed, family, ctas_per_lane, stream);
}

extern "C" int cms_query(const void* table, const uint32_t* keys, void* est,
                         uint8_t* keep, long long m, int rows, int width,
                         uint32_t seed, int family, int is_int,
                         long long thr_i, float thr_f, int grid,
                         cudaStream_t stream) {
  if (is_int)
    cms_query_kernel<int><<<grid, 256, 0, stream>>>(
        static_cast<const int*>(table), keys, static_cast<int*>(est), keep, m,
        rows, width, seed, family, thr_i, thr_f);
  else
    cms_query_kernel<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(table), keys, static_cast<float*>(est),
        keep, m, rows, width, seed, family, thr_i, thr_f);
  return cudaGetLastError();
}
