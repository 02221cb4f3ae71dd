// GROUP BY pruning (paper §4.2/§8) on Hopper: the per-lane scan.
//
// groupby_pass1 replaces the lax.scan of core.groupby.groupby_prune
// (src/repro/core/groupby.py:80-120); the JAX package has no Pallas kernel
// for it. S lanes, one per contiguous shard, each with a d x w cache of
// (key, f32 aggregate, valid) and per-entry semantics:
//   - every entry emits the row's last slot as it was before the entry
//     (key, aggregate), valid only on a miss of a valid entry that pushes a
//     valid slot out;
//   - a hit folds into the first valid slot holding the key;
//   - a miss shifts the row right by one and puts (key, fold(init, value))
//     in slot 0;
//   - an entry whose validity is 0 touches nothing.
// The fold is sum (__fadd_rn, so nvcc cannot contract or reorder it), count
// (a + 1), min or max (cheetah_min / cheetah_max: jnp.minimum and
// jnp.maximum, a NaN wins and -0 is below +0), every one with f32 subnormals
// flushed as XLA flushes them (--ftz=true); a miss's SUM is the value
// itself, as XLA simplifies 0.0 + v (fold_init). The inits +-3.4e38 are
// taken by their f32 bits. Every entry is absorbed:
// keep is all-False and the emissions are the switch->master traffic.
//
// The row-parallel walk: an entry reads and writes only the row its key
// hashes to, so after the stable partition by (lane, row) of rowpar.cuh
// (key, value bits, index with the sign bit set for an invalid entry),
// groupby_walk takes one segment a warp, the row's w slots in registers of
// every lane (templated on a bound W >= w and on the fold), its entries
// loaded through a cp.async ring up to eight chunks of 32 ahead and read
// by every lane from shared memory. An entry whose segment predecessor is
// valid with the same key (a run entry, flagged beforehand by
// groupby_mark, one thread an entry) is a hit in the slot that key sits
// in, so the warp folds a stretch of run entries as one dependent chain of
// folds with no probe (a whole chunk's values read ahead of it), and each
// of them emits the last slot as it stands, the running aggregate when the
// key sits there. Other entries take the full step. Emissions go back to
// the entries' indices; each row's final state is written, the empty rows
// included. Rows of w > 32 slots take groupby_walk_wide: every entry's full
// step on a row in shared memory, probed lane-strided.
//
// Float keys (the reference's rule, src/repro/core/groupby.py:63-90): the
// row is hashed from one key (a float32 key's bits, a float16 key's value
// converted to uint32), the slot stores another (the key converted to
// uint32 as XLA converts), and an entry hits only when its compare with the
// slot holds in the key's float type, which some entries never can
// (non-integers, negatives, NaN). The wrapper then passes ``skey``, the
// stored key of each entry, and ``nohit``, 1 for an entry that hits no
// slot; the partition carries the hashed key, and the walks read both by
// the entry's index. Both are null for integer keys.
//
// groupby_pass1_batch carries a wave of queries (core.batched): the
// query-axis partition of rowpar.cuh, the run marks, then groupby_walk_q,
// one warp a (query, lane, row) segment taking groupby_walk's steps with
// its query's w, into the batch's padded state.
//
// A resumed walk (resume = 1: the streaming fold, core.streaming) starts
// each row from the cache the outputs already hold, which its warp reads
// before anything else and writes back at its end, so the carried state is
// updated in place; the run entries stay exact, since a run entry follows
// an entry of this call whose key the row then holds.
//
// groupby_serial_kernel is the kernel the walk replaced (one thread of a
// CTA walks the lane, the cache in shared memory, 144 KB at d = 4096,
// w = 4). No entry point of the package launches it; chip_smoke.py holds
// the walk against it at full size.
//
// What bounds the walk: the longest segment's chain (a fold's latency for
// each run entry of SUM, MIN or MAX, whose order fixes the result's bits;
// none for COUNT's, whose running values are a + i; one step on registers
// for each other entry), or the bytes of the partition and the emissions.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "rowpar.cuh"

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
      return cheetah_min(a, v);
    default:
      return cheetah_max(a, v);
  }
}

// A miss's aggregate, fold(init, v): for SUM the value itself, bits and
// all, as XLA simplifies 0.0 + v to v (-0 and subnormals stay).
__device__ __forceinline__ float fold_init(int agg, float init, float v) {
  return agg == kSum ? v : fold(agg, init, v);
}

__device__ __forceinline__ float init_value(int agg) {
  if (agg == kMin) return __uint_as_float(CHEETAH_POS_BITS);
  if (agg == kMax) return __uint_as_float(CHEETAH_NEG_BITS);
  return 0.0f;
}

__global__ void groupby_serial_kernel(
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
          saggs[b] = fold_init(agg, init, xv[t]);
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


template <int kAgg>
__device__ __forceinline__ float fold_t(float a, float v) {
  return fold(kAgg, a, v);
}

// Marks the run entries of the partitioned stream: an entry whose
// predecessor is in the same lane, has the same key (so the same row) and
// is valid, as it is itself, and belongs to the same query (region: the
// entries of one query; m for a single one). Such an entry hits the slot
// that key sits in.
// The flag goes to the entry's fourth word, which the partition left 0.
__global__ void groupby_mark(uint4* __restrict__ part, long long m,
                             int shard_len, const uint8_t* __restrict__ nohit,
                             long long region) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(part);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    if (j % region == 0) continue;  // a query's first entry (a batch)
    const uint32_t k1 = words[4 * j], i1 = words[4 * j + 2];
    const uint32_t k0 = words[4 * j - 4], i0 = words[4 * j - 2];
    const bool run = k1 == k0 && !((i1 | i0) & ROWPAR_INVALID) &&
                     i1 / shard_len == i0 / shard_len &&
                     !(nohit && nohit[i1]);
    if (run) part[j].w = 1u;
  }
}

// One warp walks one segment, its entries [lo, hi) of the partitioned
// stream loaded through the warp's cp.async ring of rowpar.cuh. A chunk's
// run mask is read one chunk ahead, so that it is ready when the chunk's
// chain starts. W >= w bounds the registers. ev_*: the emissions, by the
// entry's index; *_row: the row's slots, of which wout are written (w, or
// the batch's padded width: slots past w as (0, init, invalid)).
template <int W, int kAgg>
__device__ __forceinline__ void groupby_walk_seg(
    uint4 (*ring)[32], const uint4* __restrict__ part, int lo, int hi,
    uint32_t* __restrict__ ev_k, float* __restrict__ ev_a,
    uint8_t* __restrict__ ev_valid, uint32_t* __restrict__ keys_row,
    float* __restrict__ aggs_row, uint8_t* __restrict__ valid_row, int w,
    int wout, const uint32_t* __restrict__ skey,
    const uint8_t* __restrict__ nohit, int resume, int lane) {
  const int chunks = (hi - lo + 31) >> 5;
  auto issue = [&](int c) {
    const int j = lo + (c << 5) + lane;
    const bool in = c < chunks && j < hi;
    rowpar_cp<16>(&ring[c % ROWPAR_STAGES][lane], part + (in ? j : 0),
                  in);
    rowpar_commit();
  };
  auto size = [&](int c) { return min(32, hi - lo - (c << 5)); };
  for (int c = 0; c < ROWPAR_STAGES; ++c) issue(c);
  const float init = init_value(kAgg);
  const int last = w - 1;
  const unsigned wmask = w == 32 ? ROWPAR_FULL : (1u << w) - 1u;
  uint32_t ks[W];
  float as[W];
  unsigned vm = 0u;   // valid flags, bit i for slot i
  // a resumed walk starts from the row's carried cache (read here, before
  // this warp writes the row back at its end)
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const bool in = resume && i < w;
    ks[i] = in ? keys_row[i] : 0u;
    as[i] = in ? aggs_row[i] : init;
    if (in && valid_row[i]) vm |= 1u << i;
  }
  int at = 0;         // the slot of the last valid entry's key
  // while whole-run chunks follow each other: the run's aggregate (as[at])
  // and the last slot's key and aggregate, held in registers
  bool cached = false;
  float ra = 0.0f, rla = 0.0f;
  uint32_t rk = 0u;
  rowpar_wait_for<ROWPAR_STAGES - 1>();
  __syncwarp();
  unsigned run = __ballot_sync(
      ROWPAR_FULL, chunks > 0 && lane < size(0) && ring[0][lane].w);
  for (int c = 0; c < chunks; ++c) {
    const uint4* ch = ring[c % ROWPAR_STAGES];
    const int n = size(c);
    // chunk c + 1 lands while chunk c is walked; its flag is read now and
    // voted on after the chain
    rowpar_wait_for<ROWPAR_STAGES - 2>();
    __syncwarp();
    const bool more = c + 1 < chunks;
    const uint32_t next_flag =
        more && lane < size(c + 1) ? ring[(c + 1) % ROWPAR_STAGES][lane].w
                                   : 0u;
    const uint4 en = ch[lane];
    uint32_t my_k = 0u;
    float my_a = 0.0f;
    bool my_v = false;
    if (run == ROWPAR_FULL) {
      // a whole chunk of one run, the common case of a hot row: the run's
      // aggregate and the last slot stay in registers from chunk to chunk,
      // and the chain is 32 dependent folds of values read ahead of it
      if (!cached) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (i == at) ra = as[i];
          if (i == last) {
            rk = ks[i];
            rla = as[i];
          }
        }
        cached = true;
      }
      float xs[32];
#pragma unroll
      for (int f = 0; f < 32; ++f) xs[f] = __uint_as_float(ch[f].y);
      my_k = rk;
      my_a = rla;
      if (at == last) {
#pragma unroll
        for (int f = 0; f < 32; ++f) {
          if (lane == f) my_a = ra;
          ra = fold_t<kAgg>(ra, xs[f]);
        }
      } else {
#pragma unroll
        for (int f = 0; f < 32; ++f) ra = fold_t<kAgg>(ra, xs[f]);
      }
    }
    if (run != ROWPAR_FULL && cached) {
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (i == at) as[i] = ra;
      cached = false;
    }
    int e = run == ROWPAR_FULL ? n : 0;
    while (e < n) {
      const unsigned rest = run >> e;
      if (rest & 1u) {
        // a stretch of run entries: hits in slot `at`, one chain of folds;
        // each emits the last slot, the running aggregate when at is last
        const int e2 = min(n, e + (rest == (ROWPAR_FULL >> e) ? 32 - e
                                                              : __ffs(~rest) - 1));
        float a = as[0], la = as[0];
        uint32_t lk = ks[0];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (i == at) a = as[i];
          if (i == last) {
            la = as[i];
            lk = ks[i];
          }
        }
        const bool at_last = at == last;
        my_k = e <= lane && lane < e2 ? lk : my_k;
        if (!at_last && e <= lane && lane < e2) my_a = la;
        for (int f = e; f < e2; ++f) {
          if (at_last && lane == f) my_a = a;
          a = fold_t<kAgg>(a, __uint_as_float(ch[f].y));
        }
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (i == at) as[i] = a;
        e = e2;
        continue;
      }
      const uint4 ee = ch[e];
      const uint32_t ei = ee.z & 0x7FFFFFFFu;
      const uint32_t kk = skey ? skey[ei] : ee.x;
      const bool can = !(nohit && nohit[ei]);
      const float x = __uint_as_float(ee.y);
      const bool oo = static_cast<int>(ee.z) >= 0;
      int hp = W;
      uint32_t lk = ks[0];
      float la = as[0];
#pragma unroll
      for (int i = W - 1; i >= 0; --i) {
        if (((vm >> i) & 1u) && ks[i] == kk && can) hp = i;
        if (i == last) {
          lk = ks[i];
          la = as[i];
        }
      }
      if (lane == e) {
        my_k = lk;
        my_a = la;
        my_v = ((vm >> last) & 1u) && hp == W && oo;
      }
      if (oo) {
        if (hp < W) {
#pragma unroll
          for (int i = 0; i < W; ++i)
            if (i == hp) as[i] = fold_t<kAgg>(as[i], x);
          at = hp;
        } else {
#pragma unroll
          for (int i = W - 1; i >= 1; --i) {
            ks[i] = ks[i - 1];
            as[i] = as[i - 1];
          }
          ks[0] = kk;
          as[0] = fold_init(kAgg, init, x);
          vm = ((vm << 1) | 1u) & wmask;
          at = 0;
        }
      }
      ++e;
    }
    if (lane < n) {
      const int i = static_cast<int>(en.z) & 0x7FFFFFFF;
      ev_k[i] = my_k;
      ev_a[i] = my_a;
      ev_valid[i] = my_v;
    }
    run = __ballot_sync(ROWPAR_FULL, next_flag != 0u);
    __syncwarp();  // every lane is done with slot c before it is refilled
    issue(c + ROWPAR_STAGES);
  }
  if (cached) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i == at) as[i] = ra;
  }
  rowpar_wait_all();
  for (int i = lane; i < wout; i += 32) {
    uint32_t kv = 0u;
    float av = init;
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c == i && c < w) {
        kv = ks[c];
        av = as[c];
      }
    keys_row[i] = kv;
    aggs_row[i] = av;
    valid_row[i] = (vm >> i) & 1u;
  }
}

// One warp a segment g = lane * d + row over [starts[g], starts[g + 1]).
template <int W, int kAgg>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    groupby_walk(const uint4* __restrict__ part,
                 const int* __restrict__ starts, uint32_t* __restrict__ ev_k,
                 float* __restrict__ ev_a, uint8_t* __restrict__ ev_valid,
                 uint32_t* __restrict__ keys_out, float* __restrict__ aggs_out,
                 uint8_t* __restrict__ valid_out, long long nseg, int w,
                 const uint32_t* __restrict__ skey,
                 const uint8_t* __restrict__ nohit, int resume) {
  __shared__ uint4 ring[ROWPAR_WARPS][ROWPAR_STAGES][32];
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= nseg) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long o = g * w;
  groupby_walk_seg<W, kAgg>(ring[threadIdx.x >> 5], part, starts[g],
                            starts[g + 1], ev_k, ev_a, ev_valid, keys_out + o,
                            aggs_out + o, valid_out + o, w, w, skey, nohit,
                            resume, lane);
}

template <int W>
void groupby_walk_launch(const uint4* part, const int* starts, uint32_t* ev_k,
                         float* ev_a, uint8_t* ev_valid, uint32_t* keys_out,
                         float* aggs_out, uint8_t* valid_out, long long nseg,
                         int w, int agg, const uint32_t* skey,
                         const uint8_t* nohit, int resume,
                         cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nseg * 32 + ROWPAR_THREADS - 1) /
                                                ROWPAR_THREADS);
#define CHEETAH_WALK(A)                                                       \
  groupby_walk<W, A><<<blocks, ROWPAR_THREADS, 0, stream>>>(                  \
      part, starts, ev_k, ev_a, ev_valid, keys_out, aggs_out, valid_out,     \
      nseg, w, skey, nohit, resume)
  switch (agg) {
    case kSum: CHEETAH_WALK(kSum); break;
    case kCount: CHEETAH_WALK(kCount); break;
    case kMin: CHEETAH_WALK(kMin); break;
    default: CHEETAH_WALK(kMax); break;
  }
#undef CHEETAH_WALK
}

// The walk for rows wider than a warp's registers (w > 32): one warp a
// segment, the row's keys, aggregates and valid flags in shared memory, its
// entries loaded 32 at a time (one a lane) and broadcast by shuffles; every
// entry takes the full step (a probe lane-strided, the first hit by a warp
// min), run entries included.
template <int kAgg>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    groupby_walk_wide(const uint4* __restrict__ part,
                      const int* __restrict__ starts,
                      uint32_t* __restrict__ ev_k, float* __restrict__ ev_a,
                      uint8_t* __restrict__ ev_valid,
                      uint32_t* __restrict__ keys_out,
                      float* __restrict__ aggs_out,
                      uint8_t* __restrict__ valid_out, long long nseg, int w,
                      const uint32_t* __restrict__ skey,
                      const uint8_t* __restrict__ nohit, int resume) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * warps + warp;
  if (g >= nseg) return;  // whole warps
  const size_t cells = static_cast<size_t>(warps) * w;
  uint32_t* ks = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * w;
  float* as = reinterpret_cast<float*>(smem) + cells + static_cast<size_t>(warp) * w;
  uint8_t* vb = smem + cells * 8 + static_cast<size_t>(warp) * w;
  const float init = init_value(kAgg);
  for (int i = lane; i < w; i += 32) {
    ks[i] = resume ? keys_out[g * w + i] : 0u;
    as[i] = resume ? aggs_out[g * w + i] : init;
    vb[i] = resume ? valid_out[g * w + i] : 0;
  }
  __syncwarp();
  const int last = w - 1;
  const int lo = starts[g];
  const int hi = starts[g + 1];
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int n = min(32, hi - c0);
    const uint4 en = lane < n ? part[c0 + lane] : make_uint4(0u, 0u, 0u, 0u);
    uint32_t my_k = 0u;
    float my_a = 0.0f;
    bool my_v = false;
    for (int e = 0; e < n; ++e) {
      const uint32_t ez = __shfl_sync(ROWPAR_FULL, en.z, e);
      const uint32_t ei = ez & 0x7FFFFFFFu;
      const uint32_t kk = skey ? skey[ei] : __shfl_sync(ROWPAR_FULL, en.x, e);
      const float x = __uint_as_float(__shfl_sync(ROWPAR_FULL, en.y, e));
      const bool oo = static_cast<int>(ez) >= 0;
      const int hp = nohit && nohit[ei] ? w : rowpar_first_hit(ks, vb, w, kk, lane);
      if (lane == e) {
        my_k = ks[last];
        my_a = as[last];
        my_v = vb[last] && hp == w && oo;
      }
      __syncwarp();
      if (oo) {
        if (hp < w) {
          if (lane == 0) as[hp] = fold_t<kAgg>(as[hp], x);
        } else {
          rowpar_shift(ks, last, lane);
          rowpar_shift(as, last, lane);
          rowpar_shift(vb, last, lane);
          if (lane == 0) {
            ks[0] = kk;
            as[0] = fold_init(kAgg, init, x);
            vb[0] = 1;
          }
        }
      }
      __syncwarp();
    }
    if (lane < n) {
      const int i = static_cast<int>(en.z) & 0x7FFFFFFF;
      ev_k[i] = my_k;
      ev_a[i] = my_a;
      ev_valid[i] = my_v;
    }
  }
  const long long o = g * w;
  for (int i = lane; i < w; i += 32) {
    keys_out[o + i] = ks[i];
    aggs_out[o + i] = as[i];
    valid_out[o + i] = vb[i];
  }
}

cudaError_t groupby_walk_wide_launch(const uint4* part, const int* starts,
                                     uint32_t* ev_k, float* ev_a,
                                     uint8_t* ev_valid, uint32_t* keys_out,
                                     float* aggs_out, uint8_t* valid_out,
                                     long long nseg, int w, int agg,
                                     const uint32_t* skey,
                                     const uint8_t* nohit, int resume,
                                     cudaStream_t stream) {
  const size_t row = static_cast<size_t>(w) * 9;
  const int warps = rowpar_wide_warps(row);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = warps * row;
  const unsigned blocks = static_cast<unsigned>((nseg + warps - 1) / warps);
  const void* fns[4] = {reinterpret_cast<const void*>(groupby_walk_wide<kSum>),
                        reinterpret_cast<const void*>(groupby_walk_wide<kCount>),
                        reinterpret_cast<const void*>(groupby_walk_wide<kMin>),
                        reinterpret_cast<const void*>(groupby_walk_wide<kMax>)};
  cudaError_t err = cheetah_launch_prep(fns[agg], smem);
  if (err != cudaSuccess) return err;
#define CHEETAH_WALK(A)                                                       \
  groupby_walk_wide<A><<<blocks, warps * 32, smem, stream>>>(                 \
      part, starts, ev_k, ev_a, ev_valid, keys_out, aggs_out, valid_out,     \
      nseg, w, skey, nohit, resume)
  switch (agg) {
    case kSum: CHEETAH_WALK(kSum); break;
    case kCount: CHEETAH_WALK(kCount); break;
    case kMin: CHEETAH_WALK(kMin); break;
    default: CHEETAH_WALK(kMax); break;
  }
#undef CHEETAH_WALK
  return cudaGetLastError();
}

// The batched walk (groupby_pass1_batch): a wave of queries partitioned on
// the query axis (rowpar_partition_q, with values and validity), its run
// entries marked as for one query (groupby_mark, a run never crossing the
// boundary of two queries' entries); one warp a (query, lane, row) segment
// takes the walk of groupby_walk with its query's w, emits into [Q][m] and
// writes the row into the padded state [Q][S][dcap][wcap]: slots past w
// are (0, init, invalid), as the reference's batched pads.
template <int W, int kAgg>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    groupby_walk_q(const uint4* __restrict__ part,
                   const int* __restrict__ starts, uint32_t* __restrict__ ev_k,
                   float* __restrict__ ev_a, uint8_t* __restrict__ ev_valid,
                   uint32_t* __restrict__ keys_out, float* __restrict__ aggs_out,
                   uint8_t* __restrict__ valid_out, RowparQ p,
                   const uint32_t* __restrict__ skey,
                   const uint8_t* __restrict__ nohit) {
  __shared__ uint4 ring[ROWPAR_WARPS][ROWPAR_STAGES][32];
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= p.nseg) return;  // whole warps
  int q, sl, row;
  rowpar_segment_q(p, g, &q, &sl, &row);
  const long long eo = static_cast<long long>(q) * p.shards * p.shard_len;
  const long long o = rowpar_slot_q(p, q, sl, row);
  groupby_walk_seg<W, kAgg>(ring[threadIdx.x >> 5], part, starts[g],
                            starts[g + 1], ev_k + eo, ev_a + eo, ev_valid + eo,
                            keys_out + o, aggs_out + o, valid_out + o,
                            p.w[q], p.wcap, skey, nohit, 0,
                            threadIdx.x & 31);
}

template <int W>
void groupby_walk_q_launch(const uint4* part, const int* starts,
                           uint32_t* ev_k, float* ev_a, uint8_t* ev_valid,
                           uint32_t* keys_out, float* aggs_out,
                           uint8_t* valid_out, const RowparQ& p, int agg,
                           const uint32_t* skey, const uint8_t* nohit,
                           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      (p.nseg * 32 + ROWPAR_THREADS - 1) / ROWPAR_THREADS);
#define CHEETAH_WALK(A)                                                       \
  groupby_walk_q<W, A><<<blocks, ROWPAR_THREADS, 0, stream>>>(                \
      part, starts, ev_k, ev_a, ev_valid, keys_out, aggs_out, valid_out, p,  \
      skey, nohit)
  switch (agg) {
    case kSum: CHEETAH_WALK(kSum); break;
    case kCount: CHEETAH_WALK(kCount); break;
    case kMin: CHEETAH_WALK(kMin); break;
    default: CHEETAH_WALK(kMax); break;
  }
#undef CHEETAH_WALK
}

struct GroupbyWork {
  RowparPlan plan;
  size_t partition, total;
};

GroupbyWork groupby_work(int shards, int shard_len, int d) {
  GroupbyWork k;
  k.plan = rowpar_plan(shards, shard_len, d);
  const long long m = static_cast<long long>(shards) * shard_len;
  k.partition = rowpar_partition_bytes(k.plan);
  // partition scratch; the partitioned (key, value bits, index) stream
  k.total = k.partition + rowpar_align(m * sizeof(uint4));
  return k;
}

}  // namespace

extern "C" size_t groupby_pass1_workspace(int shards, int shard_len, int d) {
  return groupby_work(shards, shard_len, d).total;
}

extern "C" int groupby_pass1(const uint32_t* keys, const float* vals,
                             const uint8_t* valid, uint32_t* ev_k, float* ev_a,
                             uint8_t* ev_valid, uint32_t* keys_out,
                             float* aggs_out, uint8_t* valid_out, int shards,
                             int shard_len, int d, int w, int agg,
                             uint32_t seed, const uint32_t* skey,
                             const uint8_t* nohit, int resume,
                             unsigned char* work, cudaStream_t stream) {
  if (w < 1 || agg < kSum || agg > kMax ||
      (w > 32 && rowpar_wide_warps(static_cast<size_t>(w) * 9) == 0))
    return cudaErrorInvalidValue;
  const GroupbyWork k = groupby_work(shards, shard_len, d);
  const long long nseg = static_cast<long long>(shards) * d;
  uint4* part = reinterpret_cast<uint4*>(work + k.partition);
  int* starts = nullptr;
  cudaError_t err = rowpar_partition(
      keys, reinterpret_cast<const uint32_t*>(vals), valid, k.plan, seed, part,
      work, &starts, stream);
  if (err != cudaSuccess) return err;
  const long long m = static_cast<long long>(shards) * shard_len;
  groupby_mark<<<static_cast<unsigned>(min((m + ROWPAR_THREADS - 1) /
                                           ROWPAR_THREADS, 132LL * 16)),
                 ROWPAR_THREADS, 0, stream>>>(part, m, shard_len, nohit,
                                               m > 0 ? m : 1);
  if (w <= 4)
    groupby_walk_launch<4>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                           aggs_out, valid_out, nseg, w, agg, skey, nohit,
                           resume, stream);
  else if (w <= 8)
    groupby_walk_launch<8>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                           aggs_out, valid_out, nseg, w, agg, skey, nohit,
                           resume, stream);
  else if (w <= 16)
    groupby_walk_launch<16>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                            aggs_out, valid_out, nseg, w, agg, skey, nohit,
                           resume, stream);
  else if (w <= 32)
    groupby_walk_launch<32>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                            aggs_out, valid_out, nseg, w, agg, skey, nohit,
                           resume, stream);
  else
    return groupby_walk_wide_launch(part, starts, ev_k, ev_a, ev_valid,
                                    keys_out, aggs_out, valid_out, nseg, w,
                                    agg, skey, nohit, resume, stream);
  return cudaGetLastError();
}

// The retired one-thread walk, for holding the row-parallel walk against
// it; launched by no entry point of the package.
extern "C" int groupby_pass1_serial(const uint32_t* keys, const float* vals,
                                    const uint8_t* valid, uint32_t* ev_k,
                                    float* ev_a, uint8_t* ev_valid,
                                    uint32_t* keys_out, float* aggs_out,
                                    uint8_t* valid_out, int shards,
                                    int shard_len, int d, int w, int agg,
                                    uint32_t seed, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(d) * w * (sizeof(uint32_t) + sizeof(float) + 1) +
      CHEETAH_STAGE * (2 * sizeof(uint32_t) + 2 * sizeof(float) +
                       sizeof(int) + 2);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(groupby_serial_kernel), smem);
  if (err != cudaSuccess) return err;
  groupby_serial_kernel<<<shards, CHEETAH_STAGE, smem, stream>>>(
      keys, vals, valid, ev_k, ev_a, ev_valid, keys_out, aggs_out, valid_out,
      shard_len, d, w, agg, seed);
  return cudaGetLastError();
}

// GROUP BY pass 1 of a wave of nq <= ROWPAR_MAX_Q queries: emissions
// [nq][m], the state [nq][shards][dcap][wcap] (the wrapper fills it with
// the pads first). d, w, seed: host arrays of nq, w <= wcap <= 32. skey,
// nohit: float keys' stored key and no-hit flags by entry (else null).
// work holds rowpar_batch_workspace(nq, shards, shard_len, d, 16).
extern "C" int groupby_pass1_batch(const uint32_t* keys, const float* vals,
                                   const uint8_t* valid, uint32_t* ev_k,
                                   float* ev_a, uint8_t* ev_valid,
                                   uint32_t* keys_out, float* aggs_out,
                                   uint8_t* valid_out, int nq, int shards,
                                   int shard_len, const int* d, const int* w,
                                   const uint32_t* seed, int dcap, int wcap,
                                   int agg, const uint32_t* skey,
                                   const uint8_t* nohit, unsigned char* work,
                                   cudaStream_t stream) {
  if (nq < 1 || nq > ROWPAR_MAX_Q || wcap < 1 || wcap > 32 || agg < kSum ||
      agg > kMax)
    return cudaErrorInvalidValue;
  for (int q = 0; q < nq; ++q)
    if (w[q] < 1 || w[q] > wcap || d[q] < 1 || d[q] > dcap)
      return cudaErrorInvalidValue;
  const RowparQ p =
      rowpar_plan_q(nq, shards, shard_len, d, w, seed, dcap, wcap);
  uint4* part = reinterpret_cast<uint4*>(work + rowpar_partition_bytes_q(p));
  int* starts = nullptr;
  cudaError_t err = rowpar_partition_q(
      keys, reinterpret_cast<const uint32_t*>(vals), valid, p, part, work,
      &starts, stream);
  if (err != cudaSuccess) return err;
  const long long m = static_cast<long long>(shards) * shard_len;
  groupby_mark<<<static_cast<unsigned>(min((nq * m + ROWPAR_THREADS - 1) /
                                           ROWPAR_THREADS, 132LL * 16)),
                 ROWPAR_THREADS, 0, stream>>>(part, nq * m, shard_len, nohit,
                                               m > 0 ? m : 1);
  if (wcap <= 4)
    groupby_walk_q_launch<4>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                             aggs_out, valid_out, p, agg, skey, nohit, stream);
  else if (wcap <= 8)
    groupby_walk_q_launch<8>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                             aggs_out, valid_out, p, agg, skey, nohit, stream);
  else if (wcap <= 16)
    groupby_walk_q_launch<16>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                              aggs_out, valid_out, p, agg, skey, nohit, stream);
  else
    groupby_walk_q_launch<32>(part, starts, ev_k, ev_a, ev_valid, keys_out,
                              aggs_out, valid_out, p, agg, skey, nohit, stream);
  return cudaGetLastError();
}
