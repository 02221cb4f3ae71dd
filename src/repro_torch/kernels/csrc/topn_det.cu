// Deterministic TOP-N pruning (paper Ex. 3, the threshold ladder) on Hopper:
// the engine's per-lane pass 1 and the run-level scan over RLE runs.
//
// The ladder state is (t0, counts[w], seen): t0 is the running minimum of
// the first N entries (started at POS), counts[i] the number of entries
// x >= t0 * 2^i seen so far, and the prune threshold t0 * 2^cur, cur the
// highest level with counts[cur] >= N. Every step is an exact f32 minimum,
// an exact multiply by a power of two, a compare or an integer count, so
// the ladder is a prefix computation: a min-scan over the warm-up entries
// and one sum-scan per level. Both kernels below are such scans over
// blocks of 256 entries (or runs), with the state carried from block to
// block. They are bit-identical with the JAX package's lax.scan and Pallas
// kernel as long as IEEE semantics hold: no --use_fast_math, no exp2f (the
// levels are t0 times 2^i built from its bits), t0 = POS times 2^i
// overflowing to inf (v >= inf is false), and the minimum propagates NaN
// as jnp.minimum does (the fold of groupby.cu for MIN does the same).
// counts and seen are int32: 2^25 rows do not come near 2^31.
//
// topn_det_pass1 replaces the lax.scan of core.topn.topn_det_prune
// (src/repro/core/topn.py:112-137), which has no Pallas kernel; it carries
// the engine's scan, sharded and two_pass modes. One CTA is one lane over
// its contiguous shard. Per block: a min-scan of the warm-up candidates
// (only while the block starts inside the first N entries of the lane),
// then for each level an inclusive sum-scan of x >= t0 * 2^i; an entry is
// kept while warm or when x >= t0 * 2^cur. Output: keep per entry and the
// lane's final (t0, counts, seen, cur_level).
//
// rle_topn_det replaces rle_topn_det_kernel (src/repro/kernels/rle_scan.py:98):
// the closed form of _run_math (rle_scan.py:51-76) for each run (v, L).
// One CTA walks all runs in blocks of 256, as the TPU's sequential grid
// does: an exclusive sum-scan of L gives each run's entering seen, a
// min-scan of the warm candidates its t0, and per level an exclusive
// sum-scan of L * ge its entering counts. A and C are computed from the
// whole ge vector, never from a level index, because ge is not a prefix in
// i when t0 <= 0. Pad runs are (POS, 0), and so are the threads past R.
//
// What bounds them: neither keeps a per-row table, so there is no chain of
// dependent shared-memory probes; the bound is the bytes (read x once,
// write keep once) and, in practice, the w + 1 block scans of three
// barriers each per block of 256.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

// POS of repro_torch.constants (+3.4e38 as float32), by its bits.
#define CHEETAH_POS_BITS 0x7f7fc99eu
#define TOPN_DET_THREADS 256
#define TOPN_DET_MAX_W 32
#define RLE_BIG (1 << 30)

namespace {

__device__ __forceinline__ float pos_value() {
  return __uint_as_float(CHEETAH_POS_BITS);
}

// 2^i for 0 <= i < 127, built from its exponent bits: exact.
__device__ __forceinline__ float pow2(int i) {
  return __int_as_float((127 + i) << 23);
}

// jnp.minimum: a NaN operand wins.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return nan_min(a, b);
  }
};

struct AddOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a + b;
  }
};

// Inclusive scan of one value a thread over the block (blockDim.x a
// multiple of 32, at most 1024): warp shuffles, then a scan of the warp
// totals by warp 0. ``buf`` is 32 slots of shared memory; ``*total`` gets
// the block's total. Ends on a barrier, so ``buf`` can be reused at once.
template <typename T, typename Op>
__device__ __forceinline__ T block_scan(T v, T* buf, Op op, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op(u, v);
  }
  if (lane == 31) buf[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = buf[lane < nw ? lane : nw - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = op(u, t);
    }
    __syncwarp();
    if (lane < nw) buf[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v = op(buf[warp - 1], v);
  *total = buf[nw - 1];
  __syncthreads();
  return v;
}

__global__ void topn_det_pass1_kernel(const float* __restrict__ x,
                                      uint8_t* __restrict__ keep,
                                      float* __restrict__ t0_out,
                                      int* __restrict__ counts_out,
                                      int* __restrict__ seen_out,
                                      int* __restrict__ cur_out,
                                      int shard_len, int N, int w) {
  __shared__ float fbuf[32];
  __shared__ int ibuf[32];
  __shared__ int counts[TOPN_DET_MAX_W];
  const float pos = pos_value();
  const float neg = cheetah_neg_value();
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  for (int i = threadIdx.x; i < w; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  float t0c = pos;  // the ladder's t0 before the block, in every thread
  for (int b0 = 0; b0 < shard_len; b0 += blockDim.x) {
    const int j = b0 + threadIdx.x;
    const bool in = j < shard_len;
    const float v = in ? x[base + j] : pos;
    float t0 = t0c;
    if (b0 < N) {  // the block holds warm-up entries: t0 still moves
      float tot;
      const float run = block_scan(in && j < N ? v : pos, fbuf, MinOp(), &tot);
      t0 = nan_min(t0c, run);
      t0c = nan_min(t0c, tot);
    }
    int cur = -1;
    for (int i = 0; i < w; ++i) {
      const int c = counts[i];
      const int ge = in && v >= __fmul_rn(t0, pow2(i));
      int tot;
      const int incl = block_scan(ge, ibuf, AddOp(), &tot);
      if (c + incl >= N) cur = i;
      if (threadIdx.x == 0) counts[i] = c + tot;
    }
    if (in) {
      const float thr = cur >= 0 ? __fmul_rn(t0, pow2(cur)) : neg;
      keep[base + j] = (j < N) || (v >= thr);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int cur = -1;
    for (int i = 0; i < w; ++i) {
      counts_out[static_cast<long long>(blockIdx.x) * w + i] = counts[i];
      if (shard_len > 0 && counts[i] >= N) cur = i;
    }
    t0_out[blockIdx.x] = t0c;
    seen_out[blockIdx.x] = shard_len;
    cur_out[blockIdx.x] = cur;
  }
}

__global__ void rle_topn_det_kernel(const float* __restrict__ rv,
                                    const int* __restrict__ rl,
                                    int* __restrict__ head,
                                    int* __restrict__ tstar, int R, int N,
                                    int w) {
  __shared__ float fbuf[32];
  __shared__ int ibuf[32];
  __shared__ int counts[TOPN_DET_MAX_W];
  const float pos = pos_value();
  for (int i = threadIdx.x; i < w; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  float t0c = pos;  // entering state of the block, in every thread
  int seen = 0;
  for (int b0 = 0; b0 < R; b0 += blockDim.x) {
    const int j = b0 + threadIdx.x;
    const bool in = j < R;
    const float v = in ? rv[j] : pos;
    const int L = in ? rl[j] : 0;
    int total_len;
    const int seen_start =
        seen + block_scan(L, ibuf, AddOp(), &total_len) - L;
    float tot;
    const float t0 = nan_min(
        t0c, block_scan(seen_start < N ? v : pos, fbuf, MinOp(), &tot));
    int cin[TOPN_DET_MAX_W];  // counts entering the run
    unsigned ge_bits = 0u;
    for (int i = 0; i < w; ++i) {
      const int c = counts[i];
      const bool ge = v >= __fmul_rn(t0, pow2(i));
      const int dl = ge ? L : 0;
      int level_total;
      cin[i] = c + block_scan(dl, ibuf, AddOp(), &level_total) - dl;
      if (ge) ge_bits |= 1u << i;
      if (threadIdx.x == 0) counts[i] = c + level_total;
    }
    int A = -1;
    for (int i = 0; i < w; ++i)
      if (!((ge_bits >> i) & 1u) && cin[i] >= N) A = i;
    int C = -1;
    for (int i = A + 1; i < w; ++i)
      if (((ge_bits >> i) & 1u) && cin[i] > C) C = cin[i];
    if (in) {
      int h = N - seen_start;
      h = h < 0 ? 0 : h;
      head[j] = h > L ? L : h;
      tstar[j] = A < 0 ? 1 : (C >= 0 ? N - C : RLE_BIG);
    }
    t0c = nan_min(t0c, tot);
    seen += total_len;
    __syncthreads();
  }
}

}  // namespace

extern "C" int topn_det_pass1(const float* x, uint8_t* keep, float* t0,
                              int* counts, int* seen, int* cur, int shards,
                              int shard_len, int N, int w,
                              cudaStream_t stream) {
  if (w < 1 || w > TOPN_DET_MAX_W) return cudaErrorInvalidValue;
  topn_det_pass1_kernel<<<shards, TOPN_DET_THREADS, 0, stream>>>(
      x, keep, t0, counts, seen, cur, shard_len, N, w);
  return cudaGetLastError();
}

extern "C" int rle_topn_det(const float* rv, const int* rl, int* head,
                            int* tstar, int R, int N, int w,
                            cudaStream_t stream) {
  if (w < 1 || w > TOPN_DET_MAX_W) return cudaErrorInvalidValue;
  rle_topn_det_kernel<<<1, TOPN_DET_THREADS, 0, stream>>>(rv, rl, head, tstar,
                                                          R, N, w);
  return cudaGetLastError();
}
