// Device-side hashing, float helpers and the launch helper shared by the
// pruning kernels.
//
// Replaces mix32 / hash_mod of src/repro/kernels/common.py:36-56 and
// multi_hash of src/repro/core/hashing.py:74-85, and is bit-exact with
// repro_torch.core.hashing: murmur3 fmix32 with a seed, then a 16-bit split
// multiply-shift range reduction below 2^16 rows (modulo above); multi_hash
// derives hash j's seed as j * 0x9E3779B9 + seed and always reduces by
// modulo. All arithmetic is uint32 and wraps exactly as on the host side,
// except the signed variant of the Pallas kernels for an int32 key below.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// NEG of repro_torch.constants (-3.4e38 as float32), by its bits so that the
// device constant cannot round differently from the host's.
#define CHEETAH_NEG_BITS 0xff7fc99eu

__device__ __forceinline__ uint32_t cheetah_mix32(uint32_t x, uint32_t seed) {
  uint32_t h = x ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// hash_mod's range reduction of a mixed hash h.
__device__ __forceinline__ int cheetah_reduce(uint32_t h, uint32_t mod) {
  if (mod < 65536u) {
    const uint32_t lo = h & 0xFFFFu;
    const uint32_t hi = h >> 16;
    const uint32_t t = hi * mod + ((lo * mod) >> 16);
    return static_cast<int>(t >> 16);
  }
  return static_cast<int>(h % mod);
}

__device__ __forceinline__ int cheetah_hash_mod(uint32_t x, uint32_t mod,
                                                uint32_t seed) {
  return cheetah_reduce(cheetah_mix32(x, seed), mod);
}

// mix32 / hash_mod as the Pallas kernels compute them on an int32 key (the
// key's own dtype): every >> arithmetic, every product wrapped as int32, the
// range reduction and its modulo signed. The mixed hash is always below 2^31
// (its last step xors the sign with itself), so a width below 2^16 is
// filled only in its lower half; at widths of 2^15 or more the multiply-shift
// gives -1 for about one key in 2^16, a probe that matches no column of the
// Pallas kernels' one-hot: callers drop it (a build adds nothing, a query
// reads 0).
__device__ __forceinline__ uint32_t cheetah_mix32_i32(uint32_t x,
                                                      uint32_t seed) {
  int h = static_cast<int>(x ^ seed);
  h ^= h >> 16;
  h = static_cast<int>(static_cast<uint32_t>(h) * 0x85EBCA6Bu);
  h ^= h >> 13;
  h = static_cast<int>(static_cast<uint32_t>(h) * 0xC2B2AE35u);
  h ^= h >> 16;
  return static_cast<uint32_t>(h);
}

// The same range reduction in the Pallas kernels' int32 arithmetic.
__device__ __forceinline__ int cheetah_reduce_i32(uint32_t hu, uint32_t mod) {
  const int h = static_cast<int>(hu);
  if (mod < 65536u) {
    const int lo = h & 0xFFFF;
    const int hi = h >> 16;
    const int t = static_cast<int>(
        static_cast<uint32_t>(hi) * mod +
        static_cast<uint32_t>(static_cast<int>(static_cast<uint32_t>(lo) * mod) >>
                              16));
    return t >> 16;
  }
  const int m = static_cast<int>(mod);
  const int r = h % m;
  return r != 0 && ((r < 0) != (m < 0)) ? r + m : r;
}

__device__ __forceinline__ int cheetah_hash_mod_i32(uint32_t x, uint32_t mod,
                                                    uint32_t seed) {
  return cheetah_reduce_i32(cheetah_mix32_i32(x, seed), mod);
}

// Hash j of multi_hash: one of ``num`` independent hashes of x.
__device__ __forceinline__ int cheetah_multi_hash(uint32_t x, uint32_t mod,
                                                  uint32_t j, uint32_t seed) {
  return static_cast<int>(cheetah_mix32(x, j * 0x9E3779B9u + seed) % mod);
}

// Shared-memory budget a block may opt into on Hopper (227 KB).
#define CHEETAH_MAX_SMEM 232448

__device__ __forceinline__ float cheetah_neg_value() {
  return __uint_as_float(CHEETAH_NEG_BITS);
}

// Order-preserving map of a float onto unsigned int, and its inverse.
__device__ __forceinline__ unsigned cheetah_ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float cheetah_unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// XLA flushes f32 subnormals to a zero of their sign in every add, minimum,
// maximum and compare, on the CPU as on a TPU, and keeps them in a copy, a
// select or a gather. Every source is compiled with --ftz=true
// (kernels/common.py), so the kernels' f32 adds, minima, maxima and compares
// flush as XLA's do. cheetah_ftz flushes a value by its bits (no float
// operation, which the compiler could fold), where it goes on to an integer
// image or through a select that stands for a computed minimum or maximum.
__device__ __forceinline__ float cheetah_ftz(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x7F800000u) ? v : __uint_as_float(u & 0x80000000u);
}

// jnp.minimum and jnp.maximum of f32: a NaN wins, -0 is below +0, and the
// result is flushed.
__device__ __forceinline__ float cheetah_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  a = cheetah_ftz(a);
  b = cheetah_ftz(b);
  return (b < a || (b == a && (__float_as_uint(b) >> 31))) ? b : a;
}

__device__ __forceinline__ float cheetah_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  a = cheetah_ftz(a);
  b = cheetah_ftz(b);
  return (a < b || (b == a && !(__float_as_uint(b) >> 31))) ? b : a;
}

// Opt a kernel into ``smem`` bytes of dynamic shared memory when it needs
// more than the default 48 KB; refuses more than a Hopper block can have.
static inline cudaError_t cheetah_launch_prep(const void* fn, size_t smem) {
  if (smem > CHEETAH_MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}
// Entries staged per round by the serial (block == 1) pass-1 kernels.
#define CHEETAH_STAGE 256
