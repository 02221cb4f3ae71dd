// SKYLINE pruning (paper Ex. 6) on Hopper: pass 1 and pass 2.
//
// skyline_pass1 replaces two pallas_calls of the JAX package:
//   skyline_prune_kernel        src/repro/kernels/skyline_prune.py:70  (S = 1)
//   skyline_shard_states_kernel src/repro/kernels/parallel.py:357      (S shards)
// and, at B = 1 with the engine's score form, the engine's per-entry scan
// (core.skyline.skyline_prune, a lax.scan in the JAX package).
// One CTA is one switch lane: it streams its contiguous shard in chunks of
// B entries and keeps the w stored points (f32[w][D]) and their scores
// (f32[w], descending, NEG = empty) in shared memory. Block semantics as in
// src/repro/kernels/ref.py: every keep decision of a chunk reads the
// pre-chunk store (keep iff no stored point with score > NEG dominates the
// entry), then w rounds each take the chunk's best remaining score, ties to
// the lowest index, and sorted-insert it while it beats the last stored
// score. A round that inserts nothing ends the chunk: later rounds have
// lower scores against the same last score.
//
// Scores: SUM (left to right) or APH, sum of e + (v/2^e - 1) for v >= 1 and
// -16 below, with e from the exponent bits and 2^e exact; mode picks the
// association, e + (m - 1) for the engine, (e + m) - 1 for the Pallas
// kernel. No log2f / exp2f: the plain version in core/skyline.py computes
// the same bits.
//
// At B = 1 the pass is the engine's per-entry scan instead, which differs
// from one-entry blocks only on NaN scores and scores <= NEG: an entry goes
// to pos = #(stored scores >= its score), is pruned by a dominator stored
// at an index below pos and is inserted at pos whenever pos < w, so a NaN
// score (pos = 0) is always inserted (src/repro/core/skyline.py:85-95). An
// APH coordinate of +inf scores NaN, as XLA's inf / exp2(inf) does.
//
// What bounds it: the serial chain of shard_len / B chunk steps. At B > 1 a
// step is a dominance test per thread, then per round a warp-shuffle arg-max
// of (ordered score, inverted index) keys, one partial per warp in shared
// memory, two barriers and a one-thread insert. At B = 1 one thread walks
// the chain; the block's other threads stage x and its scores 256 entries
// at a time.
//
// skyline_apply replaces skyline_apply_kernel (src/repro/kernels/parallel.py:398)
// and is the engine's pass 2: keep iff none of the S*w merged points with
// score > NEG dominates the entry. The merged set is staged in shared
// memory; a thread stops at the first dominator, which leaves the mask
// unchanged. Bounded by the m * S*w * D comparisons more than by bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

enum ScoreMode { kSum = 0, kAphEngine = 1, kAphKernel = 2 };

__device__ __forceinline__ float aph_term(float v, int mode) {
  if (!(v >= 1.0f)) return -16.0f;
  if (isinf(v)) return __int_as_float(0x7FC00000);  // XLA: inf / exp2(inf)
  const unsigned b = __float_as_uint(v);
  const float e = static_cast<float>(static_cast<int>(b >> 23) - 127);
  const float mant = __uint_as_float((b & 0x7FFFFFu) | 0x3F800000u);
  return mode == kAphEngine ? __fadd_rn(e, __fsub_rn(mant, 1.0f))
                            : __fsub_rn(__fadd_rn(e, mant), 1.0f);
}

__device__ __forceinline__ float score_of(const float* x, int D, int mode) {
  float acc = mode == kSum ? x[0] : aph_term(x[0], mode);
  for (int j = 1; j < D; ++j)
    acc = __fadd_rn(acc, mode == kSum ? x[j] : aph_term(x[j], mode));
  return acc;
}

// y dominates x: y >= x in every dimension and y > x in at least one.
__device__ __forceinline__ bool dominates(const float* y, const float* x,
                                          int D) {
  bool strict = false;
  for (int j = 0; j < D; ++j) {
    if (!(x[j] <= y[j])) return false;
    strict |= x[j] < y[j];
  }
  return strict;
}

// Stored scores are descending and every stored score is > NEG (an insert
// needs h > the last score >= NEG), so the valid slots are a prefix.
__device__ __forceinline__ bool dominated(const float* pts, const float* sc,
                                          int w, int D, const float* x) {
  const float neg = cheetah_neg_value();
  for (int j = 0; j < w && sc[j] > neg; ++j)
    if (dominates(pts + j * D, x, D)) return true;
  return false;
}

// Sorted insert of point p with score h; the caller has checked
// h > sc[w - 1], so pos = count(h <= sc) < w.
__device__ __forceinline__ void store_insert(float* pts, float* sc, int w,
                                             int D, const float* p, float h) {
  int pos = 0;
  for (int j = 0; j < w; ++j) pos += (h <= sc[j]);
  for (int j = w - 1; j > pos; --j) {
    sc[j] = sc[j - 1];
    for (int k = 0; k < D; ++k) pts[j * D + k] = pts[(j - 1) * D + k];
  }
  sc[pos] = h;
  for (int k = 0; k < D; ++k) pts[pos * D + k] = p[k];
}

__device__ __forceinline__ void store_init(float* pts, float* sc, int w,
                                           int D) {
  for (int i = threadIdx.x; i < w * D; i += blockDim.x) pts[i] = 0.0f;
  for (int i = threadIdx.x; i < w; i += blockDim.x) sc[i] = cheetah_neg_value();
}

__device__ __forceinline__ void store_out(const float* pts, const float* sc,
                                          float* out_pts, float* out_sc, int w,
                                          int D) {
  float* op = out_pts + static_cast<long long>(blockIdx.x) * w * D;
  float* os = out_sc + static_cast<long long>(blockIdx.x) * w;
  for (int i = threadIdx.x; i < w * D; i += blockDim.x) op[i] = pts[i];
  for (int i = threadIdx.x; i < w; i += blockDim.x) os[i] = sc[i];
}

__global__ void skyline_pass1_serial(const float* __restrict__ x,
                                     uint8_t* __restrict__ keep,
                                     float* __restrict__ out_pts,
                                     float* __restrict__ out_sc, int shard_len,
                                     int D, int w, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pts = reinterpret_cast<float*>(smem);
  float* sc = pts + w * D;
  float* xs = sc + w;
  float* hs = xs + CHEETAH_STAGE * D;
  uint8_t* ks = reinterpret_cast<uint8_t*>(hs + CHEETAH_STAGE);
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  bool nan_stored = false;  // thread 0's: a NaN score was inserted
  store_init(pts, sc, w, D);
  for (int c0 = 0; c0 < shard_len; c0 += CHEETAH_STAGE) {
    const int n = min(CHEETAH_STAGE, shard_len - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      float* xt = xs + t * D;
      const float* src = x + (base + c0 + t) * D;
      for (int k = 0; k < D; ++k) xt[k] = src[k];
      hs[t] = score_of(xt, D, mode);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // the engine's scan step: pos = #(stored scores >= h); pruned by a
      // dominator at an index below pos; inserted at pos when pos < w.
      // Until a NaN score is stored the scores stay sorted descending, and
      // pos = w exactly when h <= the last one: no count is needed.
      for (int t = 0; t < n; ++t) {
        const float* xt = xs + t * D;
        const float h = hs[t];
        int pos = w;
        if (nan_stored || !(h <= sc[w - 1])) {
          pos = 0;
          for (int j = 0; j < w; ++j) pos += (h <= sc[j]);
        }
        bool dom = false;
        for (int j = 0; j < pos && !dom; ++j) dom = dominates(pts + j * D, xt, D);
        ks[t] = !dom;
        if (pos < w) {
          for (int j = w - 1; j > pos; --j) {
            sc[j] = sc[j - 1];
            for (int k = 0; k < D; ++k) pts[j * D + k] = pts[(j - 1) * D + k];
          }
          sc[pos] = h;
          for (int k = 0; k < D; ++k) pts[pos * D + k] = xt[k];
          nan_stored |= h != h;
        }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) keep[base + c0 + t] = ks[t];
  }
  __syncthreads();
  store_out(pts, sc, out_pts, out_sc, w, D);
}

// blockDim.x = block rounded up to a whole warp; threads past block idle.
__global__ void skyline_pass1_block(const float* __restrict__ x,
                                    uint8_t* __restrict__ keep,
                                    float* __restrict__ out_pts,
                                    float* __restrict__ out_sc, int shard_len,
                                    int D, int w, int block, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* wk = reinterpret_cast<unsigned long long*>(smem);
  float* pts = reinterpret_cast<float*>(wk + 32);
  float* sc = pts + w * D;
  float* xs = sc + w;
  float* hs = xs + block * D;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool active = t < block;
  const int rounds = min(w, block);
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  store_init(pts, sc, w, D);
  __syncthreads();
  for (int c0 = 0; c0 < shard_len; c0 += block) {
    unsigned long long key = 0ull;
    if (active) {
      const long long i = base + c0 + t;
      float* xt = xs + t * D;
      for (int k = 0; k < D; ++k) xt[k] = x[i * D + k];
      keep[i] = !dominated(pts, sc, w, D, xt);
      const float h = score_of(xt, D, mode);
      hs[t] = h;
      // adding +0 folds -0 onto +0, which compare equal: the lower index
      // wins; a NaN is the block's best (jnp.max), whatever its sign bit
      const unsigned o = h != h ? 0xFFFFFFFFu : cheetah_ordered(__fadd_rn(h, 0.0f));
      key = (static_cast<unsigned long long>(o) << 32) |
            (0xFFFFFFFFu - static_cast<unsigned>(t));
    }
    bool taken = false;
    for (int r = 0; r < rounds; ++r) {
      unsigned long long k = taken ? 0ull : key;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, k, off);
        k = o > k ? o : k;
      }
      if (lane == 0) wk[warp] = k;
      __syncthreads();
      unsigned long long best = 0ull;
      for (int j = 0; j < nwarps; ++j) best = wk[j] > best ? wk[j] : best;
      const int win = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(best));
      const bool go = best != 0ull && hs[win] > sc[w - 1];
      // a NaN winner spends its round and inserts nothing (NaN > x is false)
      const bool nan = best != 0ull && hs[win] != hs[win];
      __syncthreads();
      if (!go && !nan) break;
      if (go && t == 0) store_insert(pts, sc, w, D, xs + win * D, hs[win]);
      if (t == win) taken = true;
    }
    __syncthreads();
  }
  store_out(pts, sc, out_pts, out_sc, w, D);
}

template <int D>
__global__ void skyline_apply_kernel(const float* __restrict__ x,
                                     const float* __restrict__ mp,
                                     const float* __restrict__ ms,
                                     uint8_t* __restrict__ keep, long long m,
                                     int sw, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* P = mp;
  const float* Sc = ms;
  if (staged) {
    float* sp = reinterpret_cast<float*>(smem);
    float* ss = sp + sw * D;
    for (int i = threadIdx.x; i < sw * D; i += blockDim.x) sp[i] = mp[i];
    for (int i = threadIdx.x; i < sw; i += blockDim.x) ss[i] = ms[i];
    __syncthreads();
    P = sp;
    Sc = ss;
  }
  const float neg = cheetah_neg_value();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    float xr[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xr[k] = x[i * D + k];
    bool dom = false;
    for (int j = 0; j < sw && !dom; ++j)
      dom = Sc[j] > neg && dominates(P + j * D, xr, D);
    keep[i] = !dom;
  }
}

template <int D>
cudaError_t apply_launch(const float* x, const float* mp, const float* ms,
                         uint8_t* keep, long long m, int sw, int grid,
                         cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(sw) * (D + 1) * sizeof(float);
  const int staged = bytes <= 48 * 1024;
  skyline_apply_kernel<D><<<grid, 256, staged ? bytes : 0, stream>>>(
      x, mp, ms, keep, m, sw, staged);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t skyline_pass1_smem(int D, int w, int block) {
  const size_t store = static_cast<size_t>(w) * (D + 1) * sizeof(float);
  if (block == 1)
    return store + CHEETAH_STAGE * ((D + 1) * sizeof(float) + 1);
  return 32 * sizeof(unsigned long long) + store +
         static_cast<size_t>(block) * (D + 1) * sizeof(float);
}

extern "C" int skyline_pass1(const float* x, uint8_t* keep, float* out_pts,
                             float* out_sc, int shards, int shard_len, int D,
                             int w, int block, int mode, cudaStream_t stream) {
  const size_t smem = skyline_pass1_smem(D, w, block);
  if (block == 1) {
    cudaError_t err = cheetah_launch_prep(
        reinterpret_cast<const void*>(skyline_pass1_serial), smem);
    if (err != cudaSuccess) return err;
    skyline_pass1_serial<<<shards, CHEETAH_STAGE, smem, stream>>>(
        x, keep, out_pts, out_sc, shard_len, D, w, mode);
  } else {
    cudaError_t err = cheetah_launch_prep(
        reinterpret_cast<const void*>(skyline_pass1_block), smem);
    if (err != cudaSuccess) return err;
    const int threads = (block + 31) / 32 * 32;
    skyline_pass1_block<<<shards, threads, smem, stream>>>(
        x, keep, out_pts, out_sc, shard_len, D, w, block, mode);
  }
  return cudaGetLastError();
}

extern "C" int skyline_apply(const float* x, const float* mp, const float* ms,
                             uint8_t* keep, long long m, int D, int sw,
                             int grid, cudaStream_t stream) {
  switch (D) {
    case 1: return apply_launch<1>(x, mp, ms, keep, m, sw, grid, stream);
    case 2: return apply_launch<2>(x, mp, ms, keep, m, sw, grid, stream);
    case 3: return apply_launch<3>(x, mp, ms, keep, m, sw, grid, stream);
    case 4: return apply_launch<4>(x, mp, ms, keep, m, sw, grid, stream);
    case 5: return apply_launch<5>(x, mp, ms, keep, m, sw, grid, stream);
    case 6: return apply_launch<6>(x, mp, ms, keep, m, sw, grid, stream);
    case 7: return apply_launch<7>(x, mp, ms, keep, m, sw, grid, stream);
    case 8: return apply_launch<8>(x, mp, ms, keep, m, sw, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}
