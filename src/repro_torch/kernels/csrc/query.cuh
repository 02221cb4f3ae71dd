// What the persistent queries share: cms_query (cms.cu) and bloom_query
// (bloom.cu).
//
// A persistent query runs as many CTAs of QUERY_THREADS threads as the SMs
// hold at its shared memory (query_ctas), each of which may first copy its
// table into shared memory, and then strides over the keys in steps of
// QUERY_UNITS 16-byte units (4 keys each) a thread, every unit's load
// issued before the first key is hashed. A key pointer may start at any
// 4-byte offset (a view into a column): the keys up to the first 16-byte
// boundary (the head) and those after the last whole unit (the tail) go by
// 4-byte loads (query_span). An output whose entries share the keys'
// offset mod 16 takes one vector store a unit; the wrappers allocate theirs
// so, and any other output takes 4-byte or 1-byte stores.
//
// A run-time width that is a power of two 2^k is reduced without hashing's
// integer modulo or multiply-shift (query_hash): hash_mod's multiply-shift
// of a width below 2^16 keeps the top k bits of the mixed hash (a shift;
// the Pallas int32 variant's hash is below 2^31 and so gives the same), and
// a modulo by 2^k keeps the low k bits (a mask). The kernels take it as a
// template argument (kPow2), so that a key loop holds one reduction only.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

#define QUERY_THREADS 512
#define QUERY_UNITS 2  // 16-byte units of keys a thread a step

// The reduction of a hash h to [0, mod): for a power of two (pow2),
// (h >> sh) & mk, a shift (sh = 32 - k, mk all ones: the multiply-shift of
// the kernels' families below 2^16) or a mask (sh = 0, mk = mod - 1); else
// the family's own (hash_mod's multiply-shift below 2^16 and modulo above;
// the engine's modulo).
struct QueryHash {
  uint32_t mod;
  int pow2;
  int sh;
  uint32_t mk;
};

static inline QueryHash query_hash(uint32_t mod, int family) {
  QueryHash q = {mod, 0, 0, 0u};
  if (mod == 0 || (mod & (mod - 1))) return q;
  q.pow2 = 1;
  if (family != 1 && mod > 1 && mod < 65536u) {
    int k = 0;
    while ((1u << k) < mod) ++k;
    q.sh = 32 - k;
    q.mk = 0xFFFFFFFFu;
  } else {
    q.mk = mod - 1u;
  }
  return q;
}

// Hash j's seed: the Pallas kernels' seed + 101 j (families 0 and 2), the
// engine's j * 0x9E3779B9 + seed (family 1).
template <int FAM>
__device__ __forceinline__ uint32_t query_seed(uint32_t seed, int j) {
  return FAM == 1 ? static_cast<uint32_t>(j) * 0x9E3779B9u + seed
                  : seed + 101u * static_cast<uint32_t>(j);
}

// The column of a key under hash seed s: families 0 (hash_mod on uint32
// lanes), 1 (multi_hash) and 2 (hash_mod in int32 arithmetic, whose -1, a
// dropped probe, is 0xFFFFFFFF here).
template <int FAM, bool kPow2>
__device__ __forceinline__ uint32_t query_column(uint32_t key, uint32_t s,
                                                 const QueryHash& q) {
  const uint32_t h =
      FAM == 2 ? cheetah_mix32_i32(key, s) : cheetah_mix32(key, s);
  if (kPow2) return (h >> q.sh) & q.mk;
  if (FAM == 0) return static_cast<uint32_t>(cheetah_reduce(h, q.mod));
  if (FAM == 1) return h % q.mod;
  return static_cast<uint32_t>(cheetah_reduce_i32(h, q.mod));
}

// The keys' head (4-byte loads up to the first 16-byte boundary), whole
// units of 4 keys after it, and where those end.
struct QuerySpan {
  long long head;
  long long units;
  long long body_end;
};

__host__ __device__ __forceinline__ QuerySpan query_span(const void* keys,
                                                         long long m) {
  QuerySpan s;
  s.head = ((16 - (reinterpret_cast<uintptr_t>(keys) & 15)) & 15) >> 2;
  if (s.head > m) s.head = m;
  s.units = (m - s.head) >> 2;
  s.body_end = s.head + 4 * s.units;
  return s;
}

// Whether an output of ``bytes`` a key takes one vector store a unit: its
// entry at the first unit's key sits on a vector boundary.
static inline bool query_vector_out(const void* out, int bytes,
                                    const void* keys, long long m) {
  const QuerySpan s = query_span(keys, m);
  return ((reinterpret_cast<uintptr_t>(out) + s.head * bytes) &
          (4 * bytes - 1)) == 0;
}

// The persistent grid of fn: the device's SMs times the CTAs of
// QUERY_THREADS threads and ``smem`` bytes an SM holds (at least one).
static inline cudaError_t query_ctas(const void* fn, size_t smem,
                                     int* ctas) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cheetah_launch_prep(fn, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      QUERY_THREADS, smem);
  *ctas = sms * (per_sm > 0 ? per_sm : 1);
  return e;
}

// CTAs to launch for m keys: the plan's persistent grid, but no more than
// give each CTA a step of units.
static inline unsigned query_grid(int ctas, const void* keys, long long m) {
  const QuerySpan s = query_span(keys, m);
  const long long per = static_cast<long long>(QUERY_THREADS) * QUERY_UNITS;
  long long g = (s.units + per - 1) / per;
  if (g > ctas) g = ctas;
  return static_cast<unsigned>(g < 1 ? 1 : g);
}
