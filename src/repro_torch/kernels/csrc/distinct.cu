// DISTINCT pruning (paper Ex. 2) on Hopper: pass 1 (FIFO, and LRU at B = 1)
// and pass 2.
//
// distinct_pass1 replaces two pallas_calls of the JAX package:
//   distinct_prune_kernel         src/repro/kernels/distinct_prune.py:67  (S = 1)
//   distinct_shard_states_kernel  src/repro/kernels/parallel.py:209       (S shards)
// One CTA is one switch lane over its contiguous shard. Its d x w cache sits
// in shared memory as uint32 slots, byte-wide valid flags and a FIFO head
// per row (the TPU kernel's split 16-bit f32 halves are not needed: slots
// are compared as uint32). Block semantics as in src/repro/kernels/ref.py:
// a chunk's hits read the pre-chunk cache, and the first miss of each row
// (a shared atomicMin of its chunk position) is inserted at head[row],
// which then advances mod w. At B = 1 this is core.distinct.distinct_prune
// with policy "fifo". At d = 4096, w = 4 the cache takes 112 KB, above the
// 48 KB default, so the launch opts into dynamic shared memory.
//
// With lru = 1, distinct_pass1 runs the serial kernel with the LRU step of
// core.distinct._step (src/repro/core/distinct.py:47-58), which the JAX
// package computes with lax.scan and no Pallas kernel: a hit moves its slot
// to the front (slots 1..hitpos take slots 0..hitpos-1, hitpos the first
// hit), a miss inserts at the front and the last slot falls out; head stays
// 0. The Pallas DISTINCT kernels are FIFO only, so LRU exists at B = 1 only.
//
// What bounds it: the serial chain of shard_len / B chunk steps (B = 1: one
// thread's dependent shared-memory probes of w slots per entry; B > 1: an
// atomicMin and two barriers per chunk), not bytes.
//
// distinct_apply replaces distinct_apply_kernel (src/repro/kernels/parallel.py:267):
// an entry kept by pass 1 is dropped when a valid slot of its row in the
// merged union, in the columns [0, lane * w) of the lower-ranked shards,
// holds the same fingerprint. The union [d][S*w] stays in global memory
// (L2-resident at the sizes used); the kernel is bound by bytes plus these
// probes, which only kept entries make.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

// kLru selects the cache policy at compile time, so the FIFO walk is the
// same code as without LRU.
template <bool kLru>
__global__ void distinct_pass1_serial(const uint32_t* __restrict__ x,
                                      uint8_t* __restrict__ keep,
                                      uint32_t* __restrict__ slots_out,
                                      uint8_t* __restrict__ valid_out,
                                      int* __restrict__ head_out,
                                      int shard_len, int d, int w,
                                      uint32_t seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem);
  int* head = reinterpret_cast<int*>(slots + d * w);
  uint32_t* xs = reinterpret_cast<uint32_t*>(head + d);
  int* rows = reinterpret_cast<int*>(xs + CHEETAH_STAGE);
  uint8_t* valid = reinterpret_cast<uint8_t*>(rows + CHEETAH_STAGE);
  uint8_t* ks = valid + d * w;
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  for (int i = threadIdx.x; i < d * w; i += blockDim.x) {
    slots[i] = 0u;
    valid[i] = 0;
  }
  for (int r = threadIdx.x; r < d; r += blockDim.x) head[r] = 0;
  for (int c0 = 0; c0 < shard_len; c0 += CHEETAH_STAGE) {
    const int n = min(CHEETAH_STAGE, shard_len - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const uint32_t v = x[base + c0 + t];
      xs[t] = v;
      rows[t] = cheetah_hash_mod(v, d, seed);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < n; ++t) {
        const uint32_t v = xs[t];
        const int r = rows[t];
        const int b = r * w;
        if constexpr (kLru) {
          int j = 0;  // the first hit, or w on a miss
          while (j < w && !(valid[b + j] && slots[b + j] == v)) ++j;
          ks[t] = j == w;
          for (j = j == w ? w - 1 : j; j > 0; --j) {
            slots[b + j] = slots[b + j - 1];
            valid[b + j] = valid[b + j - 1];
          }
          slots[b] = v;
          valid[b] = 1;
        } else {
          bool hit = false;
          for (int j = 0; j < w; ++j)
            hit |= valid[b + j] && slots[b + j] == v;
          ks[t] = !hit;
          if (!hit) {
            const int h = head[r];
            slots[b + h] = v;
            valid[b + h] = 1;
            head[r] = (h + 1 == w) ? 0 : h + 1;
          }
        }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) keep[base + c0 + t] = ks[t];
  }
  __syncthreads();
  const long long so = static_cast<long long>(blockIdx.x) * d * w;
  for (int i = threadIdx.x; i < d * w; i += blockDim.x) {
    slots_out[so + i] = slots[i];
    valid_out[so + i] = valid[i];
  }
  for (int r = threadIdx.x; r < d; r += blockDim.x)
    head_out[static_cast<long long>(blockIdx.x) * d + r] = head[r];
}

// blockDim.x == block: one thread per entry of a chunk.
__global__ void distinct_pass1_block(const uint32_t* __restrict__ x,
                                     uint8_t* __restrict__ keep,
                                     uint32_t* __restrict__ slots_out,
                                     uint8_t* __restrict__ valid_out,
                                     int* __restrict__ head_out,
                                     int shard_len, int d, int w,
                                     uint32_t seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem);
  int* head = reinterpret_cast<int*>(slots + d * w);
  int* first = head + d;
  uint8_t* valid = reinterpret_cast<uint8_t*>(first + d);
  const int block = blockDim.x;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  for (int i = t; i < d * w; i += block) {
    slots[i] = 0u;
    valid[i] = 0;
  }
  for (int r = t; r < d; r += block) {
    head[r] = 0;
    first[r] = block;
  }
  __syncthreads();
  for (int c0 = 0; c0 < shard_len; c0 += block) {
    const long long i = base + c0 + t;
    const uint32_t v = x[i];
    const int r = cheetah_hash_mod(v, d, seed);
    const int b = r * w;
    bool hit = false;
    for (int j = 0; j < w; ++j) hit |= valid[b + j] && slots[b + j] == v;
    keep[i] = !hit;
    if (!hit) atomicMin(&first[r], t);
    __syncthreads();
    // The row's first miss inserts and re-arms first[r]; any other miss of
    // the row reads either its winner or the re-armed value, never its own t.
    if (!hit && first[r] == t) {
      const int h = head[r];
      slots[b + h] = v;
      valid[b + h] = 1;
      head[r] = (h + 1 == w) ? 0 : h + 1;
      first[r] = block;
    }
    __syncthreads();
  }
  const long long so = static_cast<long long>(blockIdx.x) * d * w;
  for (int k = t; k < d * w; k += block) {
    slots_out[so + k] = slots[k];
    valid_out[so + k] = valid[k];
  }
  for (int r = t; r < d; r += block)
    head_out[static_cast<long long>(blockIdx.x) * d + r] = head[r];
}

__global__ void distinct_apply_kernel(const uint32_t* __restrict__ x,
                                      const uint8_t* __restrict__ keep1,
                                      const uint32_t* __restrict__ mslots,
                                      const uint8_t* __restrict__ mvalid,
                                      uint8_t* __restrict__ keep, long long m,
                                      int shard_len, int d, int w, int sw,
                                      uint32_t seed) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    if (!keep1[i]) {
      keep[i] = 0;
      continue;
    }
    const uint32_t v = x[i];
    const long long row = cheetah_hash_mod(v, d, seed);
    const uint32_t* rs = mslots + row * sw;
    const uint8_t* rv = mvalid + row * sw;
    const int ncols = static_cast<int>(i / shard_len) * w;
    bool dup = false;
    for (int c = 0; c < ncols && !dup; ++c) dup = rv[c] && rs[c] == v;
    keep[i] = !dup;
  }
}

}  // namespace

extern "C" size_t distinct_pass1_smem(int d, int w, int block) {
  const size_t cache = static_cast<size_t>(d) * w * (sizeof(uint32_t) + 1);
  if (block == 1)
    return cache + static_cast<size_t>(d) * sizeof(int) +
           CHEETAH_STAGE * (sizeof(uint32_t) + sizeof(int) + 1);
  return cache + 2 * static_cast<size_t>(d) * sizeof(int);
}

extern "C" int distinct_pass1(const uint32_t* x, uint8_t* keep, uint32_t* slots,
                              uint8_t* valid, int* head, int shards,
                              int shard_len, int d, int w, int block, int lru,
                              uint32_t seed, cudaStream_t stream) {
  const size_t smem = distinct_pass1_smem(d, w, block);
  if (block == 1) {
    const void* fn = lru ? reinterpret_cast<const void*>(distinct_pass1_serial<true>)
                         : reinterpret_cast<const void*>(distinct_pass1_serial<false>);
    cudaError_t err = cheetah_launch_prep(fn, smem);
    if (err != cudaSuccess) return err;
    if (lru)
      distinct_pass1_serial<true><<<shards, CHEETAH_STAGE, smem, stream>>>(
          x, keep, slots, valid, head, shard_len, d, w, seed);
    else
      distinct_pass1_serial<false><<<shards, CHEETAH_STAGE, smem, stream>>>(
          x, keep, slots, valid, head, shard_len, d, w, seed);
  } else {
    if (lru) return cudaErrorInvalidValue;  // LRU is per entry: B = 1 only
    cudaError_t err = cheetah_launch_prep(reinterpret_cast<const void*>(distinct_pass1_block), smem);
    if (err != cudaSuccess) return err;
    distinct_pass1_block<<<shards, block, smem, stream>>>(
        x, keep, slots, valid, head, shard_len, d, w, seed);
  }
  return cudaGetLastError();
}

extern "C" int distinct_apply(const uint32_t* x, const uint8_t* keep1,
                              const uint32_t* mslots, const uint8_t* mvalid,
                              uint8_t* keep, long long m, int shard_len, int d,
                              int w, int sw, uint32_t seed, int grid,
                              cudaStream_t stream) {
  distinct_apply_kernel<<<grid, 256, 0, stream>>>(x, keep1, mslots, mvalid, keep,
                                                  m, shard_len, d, w, sw, seed);
  return cudaGetLastError();
}
