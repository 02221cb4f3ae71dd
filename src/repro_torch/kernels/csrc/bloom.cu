// Bloom filter (paper Ex. 4, JOIN) on Hopper: build and query.
//
// bloom_build replaces bloom_build_kernel (src/repro/kernels/bloom_filter.py:39)
// and builds the engine's JOIN filters (core.sketches.bloom_build, an XLA
// scatter in the JAX package). The filter is a packed uint32 bitset (bit i
// is bit i % 32 of word i / 32), not the TPU kernel's f32[nbits] 0/1 vector.
// Every key sets its H probed bits with atomicOr; OR is idempotent, so the
// build is exact in any order. Each CTA ORs into a partial bitset in shared
// memory when it fits the default 48 KB (the ops form: nbits < 2^16, at most
// 8 KB), then flushes its non-zero words with global atomicOr; a larger
// filter (the engine's JOIN filter at 2^24 bits, 2 MB, L2-resident) takes
// global atomics directly. An optional byte mask drops entries (mask= of
// core.sketches.bloom_build).
//
// bloom_query replaces bloom_query_kernel (src/repro/kernels/bloom_filter.py:71):
// per key, the AND over its H probed bits, with an exit at the first zero.
//
// Hash family at run time: family 0 is the Pallas kernels'
// hash_mod(key, nbits, seed + 101 h), family 1 the engine's
// multi_hash(key, nbits, H, seed) (modulo, no 2^16 cap).
//
// What bounds them: bytes (read the keys once, write the bits or the keep
// mask once); the query's H gathers are random 4-byte reads of a filter
// that stays in L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

__device__ __forceinline__ uint32_t bloom_bit(uint32_t key, int h,
                                              uint32_t nbits, uint32_t seed,
                                              int family) {
  return static_cast<uint32_t>(
      family == 0
          ? cheetah_hash_mod(key, nbits, seed + 101u * static_cast<uint32_t>(h))
          : cheetah_multi_hash(key, nbits, static_cast<uint32_t>(h), seed));
}

__global__ void bloom_build_kernel(const uint32_t* __restrict__ keys,
                                   const uint8_t* __restrict__ mask,
                                   uint32_t* __restrict__ words, long long m,
                                   uint32_t nbits, int H, uint32_t seed,
                                   int family, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* part = reinterpret_cast<uint32_t*>(smem);
  const int nwords = static_cast<int>((nbits + 31u) / 32u);
  uint32_t* dst = staged ? part : words;
  if (staged) {
    for (int i = threadIdx.x; i < nwords; i += blockDim.x) part[i] = 0u;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    if (mask && !mask[i]) continue;
    const uint32_t key = keys[i];
    for (int h = 0; h < H; ++h) {
      const uint32_t b = bloom_bit(key, h, nbits, seed, family);
      atomicOr(dst + (b >> 5), 1u << (b & 31u));
    }
  }
  if (staged) {
    __syncthreads();
    for (int i = threadIdx.x; i < nwords; i += blockDim.x)
      if (part[i]) atomicOr(words + i, part[i]);
  }
}

__global__ void bloom_query_kernel(const uint32_t* __restrict__ words,
                                   const uint32_t* __restrict__ keys,
                                   uint8_t* __restrict__ keep, long long m,
                                   uint32_t nbits, int H, uint32_t seed,
                                   int family) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const uint32_t key = keys[i];
    uint8_t ok = 1;
    for (int h = 0; h < H && ok; ++h) {
      const uint32_t b = bloom_bit(key, h, nbits, seed, family);
      ok = (__ldg(words + (b >> 5)) >> (b & 31u)) & 1u;
    }
    keep[i] = ok;
  }
}

}  // namespace

extern "C" int bloom_build(const uint32_t* keys, const uint8_t* mask,
                           uint32_t* words, long long m, uint32_t nbits, int H,
                           uint32_t seed, int family, int grid,
                           cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>((nbits + 31u) / 32u) * 4;
  const int staged = bytes <= 48 * 1024;
  bloom_build_kernel<<<grid, 256, staged ? bytes : 0, stream>>>(
      keys, mask, words, m, nbits, H, seed, family, staged);
  return cudaGetLastError();
}

extern "C" int bloom_query(const uint32_t* words, const uint32_t* keys,
                           uint8_t* keep, long long m, uint32_t nbits, int H,
                           uint32_t seed, int family, int grid,
                           cudaStream_t stream) {
  bloom_query_kernel<<<grid, 256, 0, stream>>>(words, keys, keep, m, nbits, H,
                                               seed, family);
  return cudaGetLastError();
}
