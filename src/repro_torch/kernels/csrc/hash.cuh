// Device-side hashing shared by the pruning kernels.
//
// Replaces mix32 / hash_mod of src/repro/kernels/common.py:36-56 and is
// bit-exact with repro_torch.core.hashing: murmur3 fmix32 with a seed, then
// a 16-bit split multiply-shift range reduction below 2^16 rows (modulo
// above). All arithmetic is uint32 and wraps exactly as on the host side.
#pragma once

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

__device__ __forceinline__ int cheetah_hash_mod(uint32_t x, uint32_t mod,
                                                uint32_t seed) {
  const uint32_t h = cheetah_mix32(x, seed);
  if (mod < 65536u) {
    const uint32_t lo = h & 0xFFFFu;
    const uint32_t hi = h >> 16;
    const uint32_t t = hi * mod + ((lo * mod) >> 16);
    return static_cast<int>(t >> 16);
  }
  return static_cast<int>(h % mod);
}

// Shared-memory budget a block may opt into on Hopper (227 KB).
#define CHEETAH_MAX_SMEM 232448
// Entries staged per round by the serial (block == 1) pass-1 kernels.
#define CHEETAH_STAGE 256
