// GROUP BY pruning (paper §4.2/§8) on Hopper: the per-lane scan.
//
// groupby_pass1 replaces the lax.scan of core.groupby.groupby_prune
// (src/repro/core/groupby.py:80-120); the JAX package has no Pallas kernel
// for it. One CTA is one switch lane over its contiguous shard. Its d x w
// cache of (key, aggregate, valid) sits in shared memory as uint32 keys, f32
// aggregates and byte-wide valid flags: 144 KB at d = 4096, w = 4, so the
// launch opts into dynamic shared memory and refuses more than 227 KB.
// All threads stage 256 entries (key, value, validity, hashed row); one
// thread then walks them in order (per-entry semantics; the reference has no
// block form):
//   - every entry emits the row's last slot as it was before the entry
//     (key, aggregate), valid only on a miss of a valid entry that pushes a
//     valid slot out;
//   - a hit folds into the first valid slot holding the key;
//   - a miss shifts the row right by one and puts (key, fold(init, value))
//     in slot 0;
//   - an entry whose validity is 0 touches nothing.
// The fold is sum (__fadd_rn, so nvcc cannot contract or reorder it), count
// (a + 1), min or max (NaN-propagating, as torch.minimum / maximum). The
// inits +-3.4e38 are taken by their f32 bits. Every entry is absorbed:
// keep is all-False and the emissions are the switch->master traffic.
//
// What bounds it: the serial chain of shard_len dependent steps, each a few
// shared-memory round trips, not bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

// POS of repro_torch.constants (+3.4e38 as float32), by its bits.
#define CHEETAH_POS_BITS 0x7f7fc99eu

namespace {

enum Agg { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

__device__ __forceinline__ float fold(int agg, float a, float v) {
  switch (agg) {
    case kSum:
      return __fadd_rn(a, v);
    case kCount:
      return __fadd_rn(a, 1.0f);
    case kMin:
      if (a != a) return a;
      if (v != v) return v;
      return v < a ? v : a;
    default:
      if (a != a) return a;
      if (v != v) return v;
      return a < v ? v : a;
  }
}

__device__ __forceinline__ float init_value(int agg) {
  if (agg == kMin) return __uint_as_float(CHEETAH_POS_BITS);
  if (agg == kMax) return __uint_as_float(CHEETAH_NEG_BITS);
  return 0.0f;
}

__global__ void groupby_pass1_kernel(
    const uint32_t* __restrict__ keys, const float* __restrict__ vals,
    const uint8_t* __restrict__ valid, uint32_t* __restrict__ ev_k,
    float* __restrict__ ev_a, uint8_t* __restrict__ ev_valid,
    uint32_t* __restrict__ keys_out, float* __restrict__ aggs_out,
    uint8_t* __restrict__ valid_out, int shard_len, int d, int w, int agg,
    uint32_t seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cells = d * w;
  uint32_t* skeys = reinterpret_cast<uint32_t*>(smem);
  float* saggs = reinterpret_cast<float*>(skeys + cells);
  uint32_t* xk = reinterpret_cast<uint32_t*>(saggs + cells);
  float* xv = reinterpret_cast<float*>(xk + CHEETAH_STAGE);
  int* rows = reinterpret_cast<int*>(xv + CHEETAH_STAGE);
  uint32_t* ok_k = reinterpret_cast<uint32_t*>(rows + CHEETAH_STAGE);
  float* ok_a = reinterpret_cast<float*>(ok_k + CHEETAH_STAGE);
  uint8_t* svalid = reinterpret_cast<uint8_t*>(ok_a + CHEETAH_STAGE);
  uint8_t* xok = svalid + cells;
  uint8_t* ok_v = xok + CHEETAH_STAGE;
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  const float init = init_value(agg);
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    skeys[i] = 0u;
    saggs[i] = init;
    svalid[i] = 0;
  }
  for (int c0 = 0; c0 < shard_len; c0 += CHEETAH_STAGE) {
    const int n = min(CHEETAH_STAGE, shard_len - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const long long i = base + c0 + t;
      const uint32_t k = keys[i];
      xk[t] = k;
      xv[t] = vals[i];
      xok[t] = valid ? valid[i] : 1;
      rows[t] = cheetah_hash_mod(k, d, seed);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < n; ++t) {
        const uint32_t k = xk[t];
        const int b = rows[t] * w;
        const int last = b + w - 1;
        int hitpos = -1;
        for (int j = 0; j < w; ++j)
          if (svalid[b + j] && skeys[b + j] == k) {
            hitpos = j;
            break;
          }
        ok_k[t] = skeys[last];
        ok_a[t] = saggs[last];
        ok_v[t] = svalid[last] && hitpos < 0 && xok[t];
        if (!xok[t]) continue;
        if (hitpos >= 0) {
          saggs[b + hitpos] = fold(agg, saggs[b + hitpos], xv[t]);
        } else {
          for (int j = w - 1; j > 0; --j) {
            skeys[b + j] = skeys[b + j - 1];
            saggs[b + j] = saggs[b + j - 1];
            svalid[b + j] = svalid[b + j - 1];
          }
          skeys[b] = k;
          saggs[b] = fold(agg, init, xv[t]);
          svalid[b] = 1;
        }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const long long i = base + c0 + t;
      ev_k[i] = ok_k[t];
      ev_a[i] = ok_a[t];
      ev_valid[i] = ok_v[t];
    }
  }
  __syncthreads();
  const long long so = static_cast<long long>(blockIdx.x) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    keys_out[so + i] = skeys[i];
    aggs_out[so + i] = saggs[i];
    valid_out[so + i] = svalid[i];
  }
}

}  // namespace

extern "C" size_t groupby_pass1_smem(int d, int w) {
  return static_cast<size_t>(d) * w * (sizeof(uint32_t) + sizeof(float) + 1) +
         CHEETAH_STAGE * (2 * sizeof(uint32_t) + 2 * sizeof(float) +
                          sizeof(int) + 2);
}

extern "C" int groupby_pass1(const uint32_t* keys, const float* vals,
                             const uint8_t* valid, uint32_t* ev_k, float* ev_a,
                             uint8_t* ev_valid, uint32_t* keys_out,
                             float* aggs_out, uint8_t* valid_out, int shards,
                             int shard_len, int d, int w, int agg,
                             uint32_t seed, cudaStream_t stream) {
  const size_t smem = groupby_pass1_smem(d, w);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(groupby_pass1_kernel), smem);
  if (err != cudaSuccess) return err;
  groupby_pass1_kernel<<<shards, CHEETAH_STAGE, smem, stream>>>(
      keys, vals, valid, ev_k, ev_a, ev_valid, keys_out, aggs_out, valid_out,
      shard_len, d, w, agg, seed);
  return cudaGetLastError();
}
