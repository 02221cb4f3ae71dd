// Randomized TOP-N pruning (paper Ex. 7) on Hopper: pass 1 and pass 2.
//
// topn_pass1 replaces two pallas_calls of the JAX package:
//   topn_prune_kernel         src/repro/kernels/topn_prune.py:49  (S = 1)
//   topn_shard_states_kernel  src/repro/kernels/parallel.py:86    (S shards)
// One CTA is one switch lane: it streams its contiguous shard in chunks of
// B entries and keeps the f32[d][w] descending row matrix in shared memory,
// read by direct indexed loads (the TPU's one-hot matmul gathers are not
// needed here). Block semantics as in src/repro/kernels/ref.py: every keep
// decision of a chunk reads the pre-chunk matrix, and each row takes one
// sorted insert per chunk, its best candidate. At B = 1 this is the
// per-entry scan of core.topn.topn_rand_prune.
//
// What bounds it: the serial chain of shard_len / B chunk steps, not bytes.
// At B > 1 a step is a per-row atomicMax on the order-preserving integer
// image of the float, two barriers, and a pass over the d rows. At B = 1 a
// step is one dependent shared-memory round trip by one thread; the block's
// other threads stage x and the row hashes for it 256 entries at a time.
//
// topn_apply replaces topn_apply_kernel (src/repro/kernels/parallel.py:126):
// keep = x[i] >= rowmin[hash(i mod shard_len)], elementwise over m. It is
// bound by bytes (read x, write keep); rowmin is staged in shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

// Sorted insert into a descending row of w values; the caller has checked
// c > row[w - 1], so the position is < w (ref.py: pos = count(c <= row)).
__device__ __forceinline__ void insert_sorted(float* row, int w, float c) {
  int pos = 0;
  for (int j = 0; j < w; ++j) pos += (c <= row[j]);
  for (int j = w - 1; j > pos; --j) row[j] = row[j - 1];
  row[pos] = c;
}

__global__ void topn_pass1_serial(const float* __restrict__ x,
                                  uint8_t* __restrict__ keep,
                                  float* __restrict__ states, int shard_len,
                                  int d, int w, uint32_t seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);
  float* xs = st + d * w;
  int* rows = reinterpret_cast<int*>(xs + CHEETAH_STAGE);
  uint8_t* ks = reinterpret_cast<uint8_t*>(rows + CHEETAH_STAGE);
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  for (int i = threadIdx.x; i < d * w; i += blockDim.x) st[i] = cheetah_neg_value();
  for (int c0 = 0; c0 < shard_len; c0 += CHEETAH_STAGE) {
    const int n = min(CHEETAH_STAGE, shard_len - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      xs[t] = x[base + c0 + t];
      rows[t] = cheetah_hash_mod(static_cast<uint32_t>(c0 + t), d, seed);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < n; ++t) {
        const float v = xs[t];
        float* row = st + rows[t] * w;
        const float rmin = row[w - 1];
        ks[t] = v >= rmin;
        if (v > rmin) insert_sorted(row, w, v);
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) keep[base + c0 + t] = ks[t];
  }
  __syncthreads();
  float* out = states + static_cast<long long>(blockIdx.x) * d * w;
  for (int i = threadIdx.x; i < d * w; i += blockDim.x) out[i] = st[i];
}

// blockDim.x == block: one thread per entry of a chunk.
__global__ void topn_pass1_block(const float* __restrict__ x,
                                 uint8_t* __restrict__ keep,
                                 float* __restrict__ states, int shard_len,
                                 int d, int w, uint32_t seed) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);
  unsigned* cand = reinterpret_cast<unsigned*>(st + d * w);
  const unsigned neg_ord = cheetah_ordered(cheetah_neg_value());
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  const int t = threadIdx.x;
  for (int i = t; i < d * w; i += blockDim.x) st[i] = cheetah_neg_value();
  for (int r = t; r < d; r += blockDim.x) cand[r] = neg_ord;
  __syncthreads();
  for (int c0 = 0; c0 < shard_len; c0 += blockDim.x) {
    const long long i = base + c0 + t;
    const float v = x[i];
    const int row = cheetah_hash_mod(static_cast<uint32_t>(c0 + t), d, seed);
    keep[i] = v >= st[row * w + w - 1];
    atomicMax(&cand[row], cheetah_ordered(v));
    __syncthreads();
    for (int r = t; r < d; r += blockDim.x) {
      const unsigned o = cand[r];
      if (o != neg_ord) {
        const float c = cheetah_unordered(o);
        float* rowp = st + r * w;
        if (c > rowp[w - 1]) insert_sorted(rowp, w, c);
        cand[r] = neg_ord;
      }
    }
    __syncthreads();
  }
  float* out = states + static_cast<long long>(blockIdx.x) * d * w;
  for (int i = t; i < d * w; i += blockDim.x) out[i] = st[i];
}

__global__ void topn_apply_kernel(const float* __restrict__ x,
                                  const float* __restrict__ rowmin,
                                  uint8_t* __restrict__ keep, long long m,
                                  int shard_len, int d, uint32_t seed,
                                  int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* rm = rowmin;
  if (staged) {
    float* s = reinterpret_cast<float*>(smem);
    for (int r = threadIdx.x; r < d; r += blockDim.x) s[r] = rowmin[r];
    __syncthreads();
    rm = s;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const int row = cheetah_hash_mod(static_cast<uint32_t>(i % shard_len), d, seed);
    keep[i] = x[i] >= rm[row];
  }
}

}  // namespace

extern "C" size_t topn_pass1_smem(int d, int w, int block) {
  const size_t st = static_cast<size_t>(d) * w * sizeof(float);
  if (block == 1) return st + CHEETAH_STAGE * (sizeof(float) + sizeof(int) + 1);
  return st + static_cast<size_t>(d) * sizeof(unsigned);
}

extern "C" int topn_pass1(const float* x, uint8_t* keep, float* states,
                          int shards, int shard_len, int d, int w, int block,
                          uint32_t seed, cudaStream_t stream) {
  const size_t smem = topn_pass1_smem(d, w, block);
  if (block == 1) {
    cudaError_t err = cheetah_launch_prep(reinterpret_cast<const void*>(topn_pass1_serial), smem);
    if (err != cudaSuccess) return err;
    topn_pass1_serial<<<shards, CHEETAH_STAGE, smem, stream>>>(
        x, keep, states, shard_len, d, w, seed);
  } else {
    cudaError_t err = cheetah_launch_prep(reinterpret_cast<const void*>(topn_pass1_block), smem);
    if (err != cudaSuccess) return err;
    topn_pass1_block<<<shards, block, smem, stream>>>(x, keep, states,
                                                      shard_len, d, w, seed);
  }
  return cudaGetLastError();
}

extern "C" int topn_apply(const float* x, const float* rowmin, uint8_t* keep,
                          long long m, int shard_len, int d, uint32_t seed,
                          int grid, cudaStream_t stream) {
  const int staged = static_cast<size_t>(d) * sizeof(float) <= 48 * 1024;
  const size_t smem = staged ? static_cast<size_t>(d) * sizeof(float) : 0;
  topn_apply_kernel<<<grid, 256, smem, stream>>>(x, rowmin, keep, m, shard_len,
                                                 d, seed, staged);
  return cudaGetLastError();
}
