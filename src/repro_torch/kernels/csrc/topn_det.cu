// Deterministic TOP-N pruning (paper Ex. 3, the threshold ladder) on Hopper:
// the engine's per-lane pass 1 and the run-level scan over RLE runs.
//
// The ladder state is (t0, counts[w], seen): t0 is the running minimum of
// the first N entries (started at POS), counts[i] the number of entries
// x >= t0 * 2^i seen so far, and the prune threshold t0 * 2^cur, cur the
// highest level with counts[cur] >= N. Every step is an exact f32 minimum,
// an exact multiply by a power of two, a compare or an integer count, so
// the ladder is a prefix computation: a min-scan over the warm-up entries
// and one sum-scan per level. The kernels below are bit-identical with the
// JAX package's lax.scan and Pallas kernel as long as IEEE semantics hold:
// no --use_fast_math, no exp2f (the levels are t0 times 2^i built from its
// bits), t0 = POS times 2^i overflowing to inf (v >= inf is false), and the
// minimum propagates NaN as jnp.minimum does (the fold of groupby.cu for
// MIN does the same). Every minimum is combined in stream order, the
// earlier operand first, so that of equal values (-0, +0) the first stays,
// as in a serial fold. counts and seen are int32: 2^25 rows do not come
// near 2^31.
//
// topn_det_pass1 replaces the lax.scan of core.topn.topn_det_prune
// (src/repro/core/topn.py:112-137), which has no Pallas kernel; it carries
// the engine's scan, sharded and two_pass modes. Each lane is cut into
// chunks of LADDER_CHUNK entries (256 threads of 16 consecutive entries),
// and the grid is every chunk of every lane, so that one lane fills the
// card. After its first N entries a lane's t0 is fixed, and so are its
// levels; a level's count is then a plain prefix count. Five launches:
//   1. ladder_warm: the chunks that hold entries j < N of their lane each
//      take the minimum of those entries;
//   2. ladder_scan (min): an exclusive min-scan of those chunk minima per
//      lane gives each warm chunk its entering t0, and the lane's final t0
//      (its total, written to t0_out) is every later chunk's t0;
//   3. ladder_count: each chunk counts, per level, its entries with
//      x >= t0_j * 2^i (t0_j the running t0 inside a warm chunk);
//   4. ladder_scan (sum): an exclusive sum-scan of those counts over the
//      chunks of each (lane, level) gives each chunk its entering counts,
//      and the lane's final counts (written to counts_out);
//   5. ladder_keep: each chunk replays its entries from its entering
//      counts (per level, an exclusive block scan of the threads' counts)
//      and writes keep; the last chunk of a lane writes seen and cur.
// What bounds it: the bytes (x read twice, keep written once), not a
// chain: the only sequential work is the two scans over a lane's chunks.
//
// A resumed scan (resume = 1: the streaming fold, core.streaming) starts
// each lane from the (t0, counts, seen) the outputs hold: the entries with
// seen + j < N are warm, the min-scan starts from the carried t0 and the
// count scans from the carried counts. The outputs are written by phases 2,
// 4 and 5, so the carried state is first copied into the workspace, and
// every phase reads that copy: no phase reads what another has written in
// its place.
//
// topn_det_pass1_serial is the kernel the chunked scan replaced: one CTA a
// lane walks its shard in blocks of 256 with w + 1 block scans a block,
// the state carried from block to block. No entry point of the package
// launches it; chip_smoke.py holds the chunked scan against it at full
// size.
//
// rle_topn_det replaces rle_topn_det_kernel (src/repro/kernels/rle_scan.py:98):
// the closed form of _run_math (rle_scan.py:51-76) for each run (v, L),
// which is a prefix computation in three chained stages: seen (a sum of the
// lengths), t0 (a minimum of the warm runs' values) and the level counts (a
// sum of L * ge per level, ge depending on t0). The sums are the JAX
// package's int32 ones, which wrap past 2^31 (ROADMAP Queue 3 A10): here
// they are uint32 sums read as int32, so the bits are the same and the wrap
// is well defined. Under the wrap the warm runs (seen_start < N) are not a
// prefix of the runs, so every stage runs over every chunk. The runs are
// cut into chunks of RLE_CHUNK (256 threads of 8 runs, so 2^19 runs give
// 256 chunks), and each stage is a card-wide scan over the chunks, as in
// the ladder, in one cooperative launch (rle_scan_kernel) with a grid
// barrier between steps:
//   1. each chunk's length sum, then a scan of the sums (uint32 add) gives
//      each chunk its entering seen;
//   2. each chunk's minimum of its warm candidates, then a scan of the
//      minima (min, stream order) gives each chunk its entering t0;
//   3. each chunk's per-level sum of L * ge, ge against the running t0 of
//      each run, then a scan a level gives each chunk its entering counts;
//   4. each chunk replays its runs from its entering state (three block
//      scans) and writes head and tstar. A and C come from the whole ge
//      vector, never from a level index, because ge is not a prefix in i
//      when t0 <= 0.
// Every operator is associative as used (uint32 add; a minimum that keeps
// the first of equals and the first NaN), so any cut into chunks gives the
// JAX package's bits. Pad runs are (POS, 0), and so are the slots past R.
// What bounds it: latency, not bytes. Each stage reads the runs (about 18
// MiB in all with head and tstar at 2^19 runs, L2-resident after the
// first read), and the grid barriers and the one-CTA scans between them
// set the device time; the call as a whole is bound by host time. One
// launch costs less host time than the seven (four stages, three scans)
// that the same stages take as separate kernels, which is why the run
// scan is cooperative (PERF.md gives the times). The grid is as many CTAs
// as the card holds at once, at most one a chunk.
//
// rle_topn_det_serial is the kernel the chunked scan replaced: one CTA
// walks all runs in blocks of 256 with w + 2 block scans a block. It sums
// in uint32 too. No entry point of the package launches it; chip_smoke.py
// holds the chunked scan against it at full size.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace cg = cooperative_groups;

// POS of repro_torch.constants (+3.4e38 as float32), by its bits.
#define CHEETAH_POS_BITS 0x7f7fc99eu
#define TOPN_DET_THREADS 256
#define TOPN_DET_MAX_W 32
#define LADDER_THREADS 256
#define LADDER_ITEMS 16                                 // entries a thread
#define LADDER_CHUNK (LADDER_THREADS * LADDER_ITEMS)    // entries a CTA
#define LADDER_SCAN_ITEMS 8                             // values a thread a round
#define RLE_BIG (1 << 30)
#define RLE_THREADS 256
#define RLE_ITEMS 8                                     // runs a thread
#define RLE_CHUNK (RLE_THREADS * RLE_ITEMS)             // runs a CTA

namespace {

__device__ __forceinline__ float pos_value() {
  return __uint_as_float(CHEETAH_POS_BITS);
}

// 2^i for 0 <= i < 127, built from its exponent bits: exact.
__device__ __forceinline__ float pow2(int i) {
  return __int_as_float((127 + i) << 23);
}

// jnp.minimum: a NaN operand wins, -0 is below +0, subnormals flush.
__device__ __forceinline__ float nan_min(float a, float b) {
  return cheetah_min(a, b);
}

// The ladder's two scan operators. ident() is a left identity of every
// value a scan sees: the minima all start from POS.
struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return nan_min(a, b);
  }
  __device__ __forceinline__ static float ident() { return pos_value(); }
};

struct AddOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a + b;
  }
  __device__ __forceinline__ static int ident() { return 0; }
};

// The run scan's sums: uint32, which wraps as the JAX package's int32 does.
struct UAddOp {
  __device__ __forceinline__ unsigned operator()(unsigned a,
                                                 unsigned b) const {
    return a + b;
  }
  __device__ __forceinline__ static unsigned ident() { return 0u; }
};

// The int32 that a uint32 sum stands for (two's complement).
__device__ __forceinline__ int as_i32(unsigned u) {
  return static_cast<int>(u);
}

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

// Exclusive scan of one value a thread over the block, in thread order (the
// earlier operand first); ``*total`` gets the whole block's. ``buf`` is 33
// slots of shared memory. Ends on a barrier, so ``buf`` can be reused.
template <typename T, typename Op>
__device__ __forceinline__ T block_exscan(T v, T* buf, Op op, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = op(u, incl);
  }
  T ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = Op::ident();
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T t = lane < nw ? buf[lane] : Op::ident();
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = op(u, t);
    }
    T e = __shfl_up_sync(0xffffffffu, t, 1);
    if (lane == 0) e = Op::ident();
    if (lane < nw) buf[lane] = e;
    if (lane == nw - 1) buf[32] = t;
  }
  __syncthreads();
  ex = op(buf[warp], ex);
  *total = buf[32];
  __syncthreads();
  return ex;
}

// The entries of a lane that warm up its ladder: j < N - seen, seen the
// count a resumed lane carries in (seen_in; null for a fresh lane), and
// the lane's bound on them, at most n.
__device__ __forceinline__ int ladder_nwarm(int N, const int* seen_in,
                                            long long s) {
  return seen_in ? (seen_in[s] >= N ? 0 : N - seen_in[s]) : N;
}

// Phase 1: one CTA a warm chunk (blockIdx.x = lane * warm + chunk), the
// minimum of the chunk's warm entries, in stream order, from POS.
__global__ void __launch_bounds__(LADDER_THREADS)
    ladder_warm(const float* __restrict__ x, float* __restrict__ wmin, int n,
                int N, int warm, const int* __restrict__ seen_in) {
  __shared__ float buf[33];
  const long long s = blockIdx.x / warm;
  const int c = blockIdx.x % warm;
  const float* xs = x + s * n;
  const int j0 = c * LADDER_CHUNK + threadIdx.x * LADDER_ITEMS;
  const int lim = min(n, ladder_nwarm(N, seen_in, s));
  float lf = pos_value();
  for (int k = 0; k < LADDER_ITEMS; ++k)
    if (j0 + k < lim) lf = nan_min(lf, xs[j0 + k]);
  float tot;
  block_exscan(lf, buf, MinOp(), &tot);
  if (threadIdx.x == 0) wmin[blockIdx.x] = tot;
}

// The exclusive scan in order from init[row] (Op::ident() when init is
// null) of row ``row`` of ``len`` values of ``a``, in place; total[row]
// gets the row's. ``buf`` is 33 slots of shared memory; ends on a barrier.
template <typename T, typename Op>
__device__ __forceinline__ void scan_row(T* __restrict__ a,
                                         T* __restrict__ total, int len,
                                         int row, T* buf,
                                         const T* __restrict__ init = nullptr) {
  const Op op{};
  T* r = a + static_cast<long long>(row) * len;
  T carry = init ? init[row] : Op::ident();
  for (int b0 = 0; b0 < len; b0 += LADDER_THREADS * LADDER_SCAN_ITEMS) {
    const int j0 = b0 + threadIdx.x * LADDER_SCAN_ITEMS;
    T v[LADDER_SCAN_ITEMS];
    T loc = Op::ident();
#pragma unroll
    for (int k = 0; k < LADDER_SCAN_ITEMS; ++k) {
      v[k] = j0 + k < len ? r[j0 + k] : Op::ident();
      loc = op(loc, v[k]);
    }
    T tot;
    T run = op(carry, block_exscan(loc, buf, op, &tot));
#pragma unroll
    for (int k = 0; k < LADDER_SCAN_ITEMS; ++k) {
      if (j0 + k < len) r[j0 + k] = run;
      run = op(run, v[k]);
    }
    carry = op(carry, tot);
  }
  if (threadIdx.x == 0) total[row] = carry;
}

// Phases 2 and 4 of the ladder: one CTA a row of ``len`` values
// (blockIdx.x = row), from the row's carried value (init; null: fresh).
template <typename T, typename Op>
__global__ void __launch_bounds__(LADDER_THREADS)
    ladder_scan(T* __restrict__ a, T* __restrict__ total, int len,
                const T* __restrict__ init) {
  __shared__ T buf[33];
  scan_row<T, Op>(a, total, len, blockIdx.x, buf, init);
}

// The 16 entries of this thread in chunk c of a lane (xs, n entries), POS
// past the lane's end, and the t0 of each: inside a warm chunk the running
// minimum over its warm entries (j < nwarm) from the chunk's entering t0
// ``t_in``, else ``t_in``, the lane's final t0. The branch is uniform over
// the block.
__device__ __forceinline__ void ladder_items(const float* __restrict__ xs,
                                             int n, int nwarm, int c, int warm,
                                             float t_in,
                                             float (&v)[LADDER_ITEMS],
                                             float (&t0)[LADDER_ITEMS],
                                             float* buf) {
  const float pos = pos_value();
  const int j0 = c * LADDER_CHUNK + threadIdx.x * LADDER_ITEMS;
  if (j0 + LADDER_ITEMS <= n &&
      (reinterpret_cast<uintptr_t>(xs + j0) & 15u) == 0) {
    const float4* q = reinterpret_cast<const float4*>(xs + j0);
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS / 4; ++k) {
      const float4 f = __ldg(q + k);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS; ++k)
      v[k] = j0 + k < n ? xs[j0 + k] : pos;
  }
  if (c < warm) {
    const int lim = min(n, nwarm);
    float lf = pos;
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS; ++k)
      if (j0 + k < lim) lf = nan_min(lf, v[k]);
    float tot;
    float run = nan_min(t_in, block_exscan(lf, buf, MinOp(), &tot));
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS; ++k) {
      if (j0 + k < lim) run = nan_min(run, v[k]);
      t0[k] = run;
    }
  } else {
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS; ++k) t0[k] = t_in;
  }
}

// Phase 3: one CTA a chunk (blockIdx.x = lane * chunks + chunk), per level
// i < w the count of its entries with x >= t0_j * 2^i, to
// cnt[(lane * w + i) * chunks + chunk]. W >= w bounds the registers.
template <int W>
__global__ void __launch_bounds__(LADDER_THREADS)
    ladder_count(const float* __restrict__ x, const float* __restrict__ wpre,
                 const float* __restrict__ tfin, int* __restrict__ cnt, int n,
                 int N, int w, int chunks, int warm,
                 const int* __restrict__ seen_in) {
  __shared__ float buf[33];
  __shared__ int part[LADDER_THREADS / 32][W];
  const int s = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const float t_in = c < warm ? wpre[static_cast<long long>(s) * warm + c]
                              : tfin[s];
  float v[LADDER_ITEMS], t0[LADDER_ITEMS];
  ladder_items(x + static_cast<long long>(s) * n, n,
               ladder_nwarm(N, seen_in, s), c, warm, t_in, v, t0, buf);
  const int j0 = c * LADDER_CHUNK + threadIdx.x * LADDER_ITEMS;
  int cn[W];
#pragma unroll
  for (int i = 0; i < W; ++i) cn[i] = 0;
#pragma unroll
  for (int k = 0; k < LADDER_ITEMS; ++k)
    if (j0 + k < n) {
#pragma unroll
      for (int i = 0; i < W; ++i) cn[i] += v[k] >= __fmul_rn(t0[k], pow2(i));
    }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const unsigned r = __reduce_add_sync(0xffffffffu,
                                         static_cast<unsigned>(cn[i]));
    if (lane == 0) part[warp][i] = static_cast<int>(r);
  }
  __syncthreads();
  if (threadIdx.x < w) {
    int r = 0;
    for (int q = 0; q < LADDER_THREADS / 32; ++q) r += part[q][threadIdx.x];
    cnt[(static_cast<long long>(s) * w + threadIdx.x) * chunks + c] = r;
  }
}

// Phase 5: one CTA a chunk, its entries replayed from the chunk's entering
// counts (cnt after the scan): per level an exclusive scan of the threads'
// counts gives each thread its entering counts, then each entry's cur and
// keep. The last chunk of a lane writes seen and cur from the lane's
// totals.
template <int W>
__global__ void __launch_bounds__(LADDER_THREADS)
    ladder_keep(const float* __restrict__ x, const float* __restrict__ wpre,
                const float* __restrict__ tfin, const int* __restrict__ cnt,
                const int* __restrict__ totals, uint8_t* __restrict__ keep,
                int* __restrict__ seen_out, int* __restrict__ cur_out, int n,
                int N, int w, int chunks, int warm,
                const int* __restrict__ seen_in) {
  __shared__ float buf[33];
  __shared__ int part[LADDER_THREADS / 32][W];
  const int s = blockIdx.x / chunks;
  const int c = blockIdx.x % chunks;
  const float t_in = c < warm ? wpre[static_cast<long long>(s) * warm + c]
                              : tfin[s];
  float v[LADDER_ITEMS], t0[LADDER_ITEMS];
  ladder_items(x + static_cast<long long>(s) * n, n,
               ladder_nwarm(N, seen_in, s), c, warm, t_in, v, t0, buf);
  const int j0 = c * LADDER_CHUNK + threadIdx.x * LADDER_ITEMS;
  int loc[W];  // this thread's count of each level
#pragma unroll
  for (int i = 0; i < W; ++i) loc[i] = 0;
#pragma unroll
  for (int k = 0; k < LADDER_ITEMS; ++k)
    if (j0 + k < n) {
#pragma unroll
      for (int i = 0; i < W; ++i) loc[i] += v[k] >= __fmul_rn(t0[k], pow2(i));
    }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int run[W];  // the counts entering this thread's first entry
#pragma unroll
  for (int i = 0; i < W; ++i) {
    int incl = loc[i];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) part[warp][i] = incl;
    run[i] = incl - loc[i];  // exclusive within the warp
  }
  __syncthreads();
  // cur only grows (counts only grow), so when the levels reaching N are
  // the same before and after the thread's entries, cur is one value for
  // all of them; only a thread where a level reaches N replays level by
  // level, at most w threads a lane.
  int cur_first = -1, cur_last = -1;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    int e = i < w ? cnt[(static_cast<long long>(s) * w + i) * chunks + c] : 0;
    for (int q = 0; q < warp; ++q) e += part[q][i];
    run[i] += e;
    if (i < w && run[i] >= N) cur_first = i;
    if (i < w && run[i] + loc[i] >= N) cur_last = i;
  }
  const float neg = cheetah_neg_value();
  const int nwarm = ladder_nwarm(N, seen_in, s);
  uint8_t kp[LADDER_ITEMS];
  if (cur_first == cur_last) {
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS; ++k) {
      const float thr =
          cur_first >= 0 ? __fmul_rn(t0[k], pow2(cur_first)) : neg;
      kp[k] = (j0 + k < nwarm) || (v[k] >= thr);
    }
  } else {
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS; ++k) {
      const int j = j0 + k;
      int cur = -1;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        run[i] += j < n && v[k] >= __fmul_rn(t0[k], pow2(i));
        if (i < w && run[i] >= N) cur = i;
      }
      const float thr = cur >= 0 ? __fmul_rn(t0[k], pow2(cur)) : neg;
      kp[k] = (j < nwarm) || (v[k] >= thr);
    }
  }
  uint8_t* kd = keep + static_cast<long long>(s) * n + j0;
  if (j0 + LADDER_ITEMS <= n && (reinterpret_cast<uintptr_t>(kd) & 15u) == 0) {
    unsigned q[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      q[h] = kp[4 * h] | (kp[4 * h + 1] << 8) | (kp[4 * h + 2] << 16) |
             (static_cast<unsigned>(kp[4 * h + 3]) << 24);
    *reinterpret_cast<uint4*>(kd) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int k = 0; k < LADDER_ITEMS; ++k)
      if (j0 + k < n) kd[k] = kp[k];
  }
  if (c == chunks - 1 && threadIdx.x == 0) {
    int cur = -1;
    for (int i = 0; i < w; ++i)
      if (totals[static_cast<long long>(s) * w + i] >= N) cur = i;
    // seen is int32 and wraps, as the reference's seen + 1 does
    seen_out[s] = static_cast<int>(
        (seen_in ? static_cast<unsigned>(seen_in[s]) : 0u) +
        static_cast<unsigned>(n));
    cur_out[s] = cur;
  }
}

// The chunked scan's plan for S lanes of n entries: chunks a lane, warm
// chunks a lane (those holding entries j < N, a bound for a resumed lane),
// and the workspace: the warm chunks' minima [S][warm], the level counts
// [S][w][chunks], then a resumed scan's copy of the carried t0 [S], counts
// [S][w] and seen [S].
struct LadderPlan {
  int chunks, warm;
  size_t wmin_bytes, cnt_bytes, carry, total;
};

static inline size_t ladder_align(size_t b) { return (b + 255) & ~size_t(255); }

static inline LadderPlan ladder_plan(int shards, int n, int N, int w) {
  LadderPlan p;
  p.chunks = (n + LADDER_CHUNK - 1) / LADDER_CHUNK;
  const int lim = N < n ? N : n;
  p.warm = lim > 0 ? (lim + LADDER_CHUNK - 1) / LADDER_CHUNK : 0;
  p.wmin_bytes = ladder_align(static_cast<size_t>(shards) *
                              (p.warm > 0 ? p.warm : 1) * sizeof(float));
  p.cnt_bytes = ladder_align(static_cast<size_t>(shards) * w *
                             (p.chunks > 0 ? p.chunks : 1) * sizeof(int));
  p.carry = p.wmin_bytes + p.cnt_bytes;
  p.total = p.carry + 3 * ladder_align(static_cast<size_t>(shards) * w *
                                       sizeof(int));
  return p;
}

template <int W>
void ladder_levels(const float* x, uint8_t* keep, float* t0, int* counts,
                   int* seen, int* cur, int shards, int n, int N, int w,
                   const LadderPlan& p, float* wmin, int* cnt,
                   const int* cnt_in, const int* seen_in,
                   cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(shards) * p.chunks;
  ladder_count<W><<<grid, LADDER_THREADS, 0, stream>>>(
      x, wmin, t0, cnt, n, N, w, p.chunks, p.warm, seen_in);
  ladder_scan<int, AddOp><<<static_cast<unsigned>(shards) * w,
                            LADDER_THREADS, 0, stream>>>(cnt, counts,
                                                         p.chunks, cnt_in);
  ladder_keep<W><<<grid, LADDER_THREADS, 0, stream>>>(
      x, wmin, t0, cnt, counts, keep, seen, cur, n, N, w, p.chunks, p.warm,
      seen_in);
}

// The retired one-CTA-a-lane ladder (see the header).
__global__ void topn_det_serial_kernel(const float* __restrict__ x,
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

// ---------------------------------------------------------------- RLE runs
// The shared memory of one CTA of the run scan.
template <int W>
struct RleSmem {
  unsigned ubuf[33];
  float fbuf[33];
  unsigned part[RLE_THREADS / 32][W];
};

// This thread's RLE_ITEMS runs of chunk c: values and lengths, (POS, 0)
// past R. 16-byte loads where the runs are whole and aligned.
__device__ __forceinline__ void rle_load(const float* __restrict__ rv,
                                         const int* __restrict__ rl, int R,
                                         int c, float (&v)[RLE_ITEMS],
                                         unsigned (&L)[RLE_ITEMS]) {
  const int j0 = c * RLE_CHUNK + threadIdx.x * RLE_ITEMS;
  if (j0 + RLE_ITEMS <= R &&
      ((reinterpret_cast<uintptr_t>(rv + j0) |
        reinterpret_cast<uintptr_t>(rl + j0)) & 15u) == 0) {
#pragma unroll
    for (int k = 0; k < RLE_ITEMS / 4; ++k) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(rv + j0) + k);
      const int4 l = __ldg(reinterpret_cast<const int4*>(rl + j0) + k);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
      L[4 * k] = l.x;
      L[4 * k + 1] = l.y;
      L[4 * k + 2] = l.z;
      L[4 * k + 3] = l.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RLE_ITEMS; ++k) {
      v[k] = j0 + k < R ? rv[j0 + k] : pos_value();
      L[k] = j0 + k < R ? static_cast<unsigned>(rl[j0 + k]) : 0u;
    }
  }
}

// Each run's seen_start, from the chunk's entering seen ``seen_in``.
__device__ __forceinline__ void rle_seen(const unsigned (&L)[RLE_ITEMS],
                                         unsigned seen_in,
                                         unsigned (&ss)[RLE_ITEMS],
                                         unsigned* ubuf) {
  unsigned loc = 0u;
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) loc += L[k];
  unsigned tot;
  unsigned run = seen_in + block_exscan(loc, ubuf, UAddOp(), &tot);
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) {
    ss[k] = run;
    run += L[k];
  }
}

// Each run's t0 (the running minimum of the warm runs' values from the
// chunk's entering t0 ``t_in``); returns the chunk's own minimum of its
// warm runs, in stream order, from POS.
__device__ __forceinline__ float rle_t0(const float (&v)[RLE_ITEMS],
                                        const unsigned (&ss)[RLE_ITEMS],
                                        int N, float t_in,
                                        float (&t0)[RLE_ITEMS], float* fbuf) {
  float lf = pos_value();
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k)
    if (as_i32(ss[k]) < N) lf = nan_min(lf, v[k]);
  float tot;
  float run = nan_min(t_in, block_exscan(lf, fbuf, MinOp(), &tot));
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) {
    if (as_i32(ss[k]) < N) run = nan_min(run, v[k]);
    t0[k] = run;
  }
  return tot;
}

// Stage 1: the chunk's length sum, to lsum[c].
__device__ __forceinline__ void rle_len_sum_body(const int* __restrict__ rl,
                                                 unsigned* __restrict__ lsum,
                                                 int R, int c,
                                                 unsigned* ubuf) {
  const int j0 = c * RLE_CHUNK + threadIdx.x * RLE_ITEMS;
  unsigned loc = 0u;
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k)
    if (j0 + k < R) loc += static_cast<unsigned>(rl[j0 + k]);
  unsigned tot;
  block_exscan(loc, ubuf, UAddOp(), &tot);
  if (threadIdx.x == 0) lsum[c] = tot;
}

// Stage 2: the chunk's minimum of its warm candidates, to cmin[c]; seen_in
// is lsum after its scan.
__device__ __forceinline__ void rle_cand_min_body(
    const float* __restrict__ rv, const int* __restrict__ rl,
    const unsigned* __restrict__ seen_in, float* __restrict__ cmin, int R,
    int N, int c, unsigned* ubuf, float* fbuf) {
  float v[RLE_ITEMS], t0[RLE_ITEMS];
  unsigned L[RLE_ITEMS], ss[RLE_ITEMS];
  rle_load(rv, rl, R, c, v, L);
  rle_seen(L, seen_in[c], ss, ubuf);
  const float tot = rle_t0(v, ss, N, pos_value(), t0, fbuf);
  if (threadIdx.x == 0) cmin[c] = tot;
}

// This thread's runs of chunk c with their seen_start and t0, from the
// chunk's entering seen and t0 (seen_in and t0_in after their scans).
__device__ __forceinline__ void rle_state(
    const float* __restrict__ rv, const int* __restrict__ rl,
    const unsigned* __restrict__ seen_in, const float* __restrict__ t0_in,
    int R, int N, int c, float (&v)[RLE_ITEMS], unsigned (&L)[RLE_ITEMS],
    unsigned (&ss)[RLE_ITEMS], float (&t0)[RLE_ITEMS], unsigned* ubuf,
    float* fbuf) {
  rle_load(rv, rl, R, c, v, L);
  rle_seen(L, seen_in[c], ss, ubuf);
  rle_t0(v, ss, N, t0_in[c], t0, fbuf);
}

// Stage 3: the chunk's per-level sums of L * ge, to lev[i * chunks + c].
template <int W>
__device__ __forceinline__ void rle_level_sum_body(
    const float* __restrict__ rv, const int* __restrict__ rl,
    const unsigned* __restrict__ seen_in, const float* __restrict__ t0_in,
    unsigned* __restrict__ lev, int R, int N, int w, int chunks, int c,
    RleSmem<W>& sm) {
  float v[RLE_ITEMS], t0[RLE_ITEMS];
  unsigned L[RLE_ITEMS], ss[RLE_ITEMS];
  rle_state(rv, rl, seen_in, t0_in, R, N, c, v, L, ss, t0, sm.ubuf, sm.fbuf);
  unsigned cn[W];
#pragma unroll
  for (int i = 0; i < W; ++i) cn[i] = 0u;
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      cn[i] += v[k] >= __fmul_rn(t0[k], pow2(i)) ? L[k] : 0u;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const unsigned r = __reduce_add_sync(0xffffffffu, cn[i]);
    if (lane == 0) sm.part[warp][i] = r;
  }
  __syncthreads();
  if (threadIdx.x < w) {
    unsigned r = 0u;
    for (int q = 0; q < RLE_THREADS / 32; ++q) r += sm.part[q][threadIdx.x];
    lev[static_cast<long long>(threadIdx.x) * chunks + c] = r;
  }
  __syncthreads();
}

// Stage 4: chunk c's runs replayed from its entering state (lev after its
// scan holds the entering counts): head and tstar of each run.
template <int W>
__device__ __forceinline__ void rle_replay_body(
    const float* __restrict__ rv, const int* __restrict__ rl,
    const unsigned* __restrict__ seen_in, const float* __restrict__ t0_in,
    const unsigned* __restrict__ lev, int* __restrict__ head,
    int* __restrict__ tstar, int R, int N, int w, int chunks, int c,
    RleSmem<W>& sm) {
  float v[RLE_ITEMS], t0[RLE_ITEMS];
  unsigned L[RLE_ITEMS], ss[RLE_ITEMS];
  rle_state(rv, rl, seen_in, t0_in, R, N, c, v, L, ss, t0, sm.ubuf, sm.fbuf);
  unsigned loc[W];  // this thread's sum of L * ge per level
#pragma unroll
  for (int i = 0; i < W; ++i) loc[i] = 0u;
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      loc[i] += v[k] >= __fmul_rn(t0[k], pow2(i)) ? L[k] : 0u;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned run[W];  // the counts entering this thread's first run
#pragma unroll
  for (int i = 0; i < W; ++i) {
    unsigned incl = loc[i];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) sm.part[warp][i] = incl;
    run[i] = incl - loc[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < W; ++i) {
    unsigned e = i < w ? lev[static_cast<long long>(i) * chunks + c] : 0u;
    for (int q = 0; q < warp; ++q) e += sm.part[q][i];
    run[i] += e;
  }
  __syncthreads();
  const unsigned uN = static_cast<unsigned>(N);
  int hd[RLE_ITEMS], ts[RLE_ITEMS];
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) {
    unsigned ge = 0u;
    int A = -1;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const bool g = i < w && v[k] >= __fmul_rn(t0[k], pow2(i));
      ge |= static_cast<unsigned>(g) << i;
      if (i < w && !g && as_i32(run[i]) >= N) A = i;
    }
    int C = -1;
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i > A && ((ge >> i) & 1u) && as_i32(run[i]) > C) C = as_i32(run[i]);
#pragma unroll
    for (int i = 0; i < W; ++i) run[i] += ((ge >> i) & 1u) ? L[k] : 0u;
    int h = as_i32(uN - ss[k]);
    h = h < 0 ? 0 : h;
    hd[k] = h > as_i32(L[k]) ? as_i32(L[k]) : h;
    ts[k] = A < 0 ? 1
                  : (C >= 0 ? as_i32(uN - static_cast<unsigned>(C)) : RLE_BIG);
  }
  const int j0 = c * RLE_CHUNK + threadIdx.x * RLE_ITEMS;
  if (j0 + RLE_ITEMS <= R &&
      ((reinterpret_cast<uintptr_t>(head + j0) |
        reinterpret_cast<uintptr_t>(tstar + j0)) & 15u) == 0) {
#pragma unroll
    for (int k = 0; k < RLE_ITEMS / 4; ++k) {
      reinterpret_cast<int4*>(head + j0)[k] =
          make_int4(hd[4 * k], hd[4 * k + 1], hd[4 * k + 2], hd[4 * k + 3]);
      reinterpret_cast<int4*>(tstar + j0)[k] =
          make_int4(ts[4 * k], ts[4 * k + 1], ts[4 * k + 2], ts[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < RLE_ITEMS; ++k)
      if (j0 + k < R) {
        head[j0 + k] = hd[k];
        tstar[j0 + k] = ts[k];
      }
  }
}

// The four stages and three scans in one cooperative launch: each CTA
// takes chunks blockIdx.x, blockIdx.x + gridDim.x, ..., and a grid barrier
// separates the steps. The scans of the chunk totals are one CTA's (the
// levels' one CTA a level), as in ladder_scan.
template <int W>
__global__ void __launch_bounds__(RLE_THREADS)
    rle_scan_kernel(const float* __restrict__ rv, const int* __restrict__ rl,
             unsigned* __restrict__ lsum, float* __restrict__ cmin,
             unsigned* __restrict__ lev, unsigned* __restrict__ utot,
             float* __restrict__ ftot, int* __restrict__ head,
             int* __restrict__ tstar, int R, int N, int w, int chunks) {
  __shared__ RleSmem<W> sm;
  cg::grid_group grid = cg::this_grid();
  for (int c = blockIdx.x; c < chunks; c += gridDim.x)
    rle_len_sum_body(rl, lsum, R, c, sm.ubuf);
  grid.sync();
  if (blockIdx.x == 0) scan_row<unsigned, UAddOp>(lsum, utot, chunks, 0,
                                                  sm.ubuf);
  grid.sync();
  for (int c = blockIdx.x; c < chunks; c += gridDim.x)
    rle_cand_min_body(rv, rl, lsum, cmin, R, N, c, sm.ubuf, sm.fbuf);
  grid.sync();
  if (blockIdx.x == 0) scan_row<float, MinOp>(cmin, ftot, chunks, 0,
                                              sm.fbuf);
  grid.sync();
  for (int c = blockIdx.x; c < chunks; c += gridDim.x)
    rle_level_sum_body<W>(rv, rl, lsum, cmin, lev, R, N, w, chunks, c, sm);
  grid.sync();
  for (int i = blockIdx.x; i < w; i += gridDim.x)
    scan_row<unsigned, UAddOp>(lev, utot + 1, chunks, i, sm.ubuf);
  grid.sync();
  for (int c = blockIdx.x; c < chunks; c += gridDim.x)
    rle_replay_body<W>(rv, rl, lsum, cmin, lev, head, tstar, R, N, w, chunks,
                       c, sm);
}

// The retired one-CTA run scan (see the header), its sums in uint32.
__global__ void rle_topn_det_serial_kernel(const float* __restrict__ rv,
                                           const int* __restrict__ rl,
                                           int* __restrict__ head,
                                           int* __restrict__ tstar, int R,
                                           int N, int w) {
  __shared__ float fbuf[32];
  __shared__ unsigned ibuf[32];
  __shared__ unsigned counts[TOPN_DET_MAX_W];
  const float pos = pos_value();
  const unsigned uN = static_cast<unsigned>(N);
  for (int i = threadIdx.x; i < w; i += blockDim.x) counts[i] = 0u;
  __syncthreads();
  float t0c = pos;  // entering state of the block, in every thread
  unsigned seen = 0u;
  for (int b0 = 0; b0 < R; b0 += blockDim.x) {
    const int j = b0 + threadIdx.x;
    const bool in = j < R;
    const float v = in ? rv[j] : pos;
    const unsigned L = in ? static_cast<unsigned>(rl[j]) : 0u;
    unsigned total_len;
    const unsigned seen_start =
        seen + block_scan(L, ibuf, UAddOp(), &total_len) - L;
    float tot;
    const float t0 = nan_min(
        t0c, block_scan(as_i32(seen_start) < N ? v : pos, fbuf, MinOp(),
                        &tot));
    unsigned cin[TOPN_DET_MAX_W];  // counts entering the run
    unsigned ge_bits = 0u;
    for (int i = 0; i < w; ++i) {
      const unsigned c = counts[i];
      const bool ge = v >= __fmul_rn(t0, pow2(i));
      const unsigned dl = ge ? L : 0u;
      unsigned level_total;
      cin[i] = c + block_scan(dl, ibuf, UAddOp(), &level_total) - dl;
      if (ge) ge_bits |= 1u << i;
      if (threadIdx.x == 0) counts[i] = c + level_total;
    }
    int A = -1;
    for (int i = 0; i < w; ++i)
      if (!((ge_bits >> i) & 1u) && as_i32(cin[i]) >= N) A = i;
    int C = -1;
    for (int i = A + 1; i < w; ++i)
      if (((ge_bits >> i) & 1u) && as_i32(cin[i]) > C) C = as_i32(cin[i]);
    if (in) {
      int h = as_i32(uN - seen_start);
      h = h < 0 ? 0 : h;
      head[j] = h > as_i32(L) ? as_i32(L) : h;
      tstar[j] = A < 0 ? 1
                       : (C >= 0 ? as_i32(uN - static_cast<unsigned>(C))
                                 : RLE_BIG);
    }
    t0c = nan_min(t0c, tot);
    seen += total_len;
    __syncthreads();
  }
}

// The run scan's plan for R runs and w levels: chunks, and the workspace:
// the chunk length sums [chunks], the chunk minima [chunks], the level sums
// [w][chunks], then the scans' totals (seen, the levels) and t0's total.
struct RlePlan {
  int chunks;
  size_t cmin_off, lev_off, utot_off, ftot_off, total;
};

static inline RlePlan rle_plan(int R, int w) {
  RlePlan p;
  p.chunks = (R + RLE_CHUNK - 1) / RLE_CHUNK;
  const size_t k = p.chunks > 0 ? p.chunks : 1;
  p.cmin_off = ladder_align(k * sizeof(unsigned));
  p.lev_off = p.cmin_off + ladder_align(k * sizeof(float));
  p.utot_off = p.lev_off + ladder_align(static_cast<size_t>(w) * k *
                                        sizeof(unsigned));
  p.ftot_off = p.utot_off + ladder_align((1 + w) * sizeof(unsigned));
  p.total = p.ftot_off + ladder_align(sizeof(float));
  return p;
}

// The co-resident CTAs of the run scan on the current device: the grid of
// its cooperative launch, found once a device and kept.
template <int W>
cudaError_t rle_grid_cap(int* cap) {
  static int caps[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && caps[dev] > 0) {
    *cap = caps[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rle_scan_kernel<W>, RLE_THREADS, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *cap = per_sm * sms;
  if (dev < 64) caps[dev] = *cap;
  return cudaSuccess;
}

template <int W>
cudaError_t rle_launch(const float* rv, const int* rl, int* head, int* tstar,
                       int R, int N, int w, unsigned char* work,
                       cudaStream_t stream) {
  const RlePlan p = rle_plan(R, w);
  unsigned* lsum = reinterpret_cast<unsigned*>(work);
  float* cmin = reinterpret_cast<float*>(work + p.cmin_off);
  unsigned* lev = reinterpret_cast<unsigned*>(work + p.lev_off);
  unsigned* utot = reinterpret_cast<unsigned*>(work + p.utot_off);
  float* ftot = reinterpret_cast<float*>(work + p.ftot_off);
  int chunks = p.chunks;
  int cap = 0;
  const cudaError_t e = rle_grid_cap<W>(&cap);
  if (e != cudaSuccess) return e;
  const int grid = chunks < cap ? chunks : cap;
  void* args[] = {&rv, &rl, &lsum, &cmin, &lev, &utot, &ftot,
                  &head, &tstar, &R, &N, &w, &chunks};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rle_scan_kernel<W>), dim3(grid),
      dim3(RLE_THREADS), args, 0, stream);
}

}  // namespace

extern "C" size_t topn_det_pass1_workspace(int shards, int shard_len, int N,
                                           int w) {
  return ladder_plan(shards, shard_len, N, w).total;
}

// The chunked scan over S lanes of shard_len > 0 entries; work holds
// topn_det_pass1_workspace bytes. resume (the streaming fold): each lane's
// ladder starts from the (t0, counts, seen) the outputs hold, copied into
// the workspace before the first launch, since the scans write the outputs
// (t0 in phase 2, counts in phase 4, seen and cur in phase 5).
extern "C" int topn_det_pass1(const float* x, uint8_t* keep, float* t0,
                              int* counts, int* seen, int* cur, int shards,
                              int shard_len, int N, int w, int resume,
                              unsigned char* work, cudaStream_t stream) {
  if (w < 1 || w > TOPN_DET_MAX_W || shards < 1 || shard_len < 1)
    return cudaErrorInvalidValue;
  const LadderPlan p = ladder_plan(shards, shard_len, N, w);
  float* wmin = reinterpret_cast<float*>(work);
  int* cnt = reinterpret_cast<int*>(work + p.wmin_bytes);
  const size_t slot = ladder_align(static_cast<size_t>(shards) * w * sizeof(int));
  float* t0_in = nullptr;
  int* cnt_in = nullptr;
  int* seen_in = nullptr;
  if (resume) {
    t0_in = reinterpret_cast<float*>(work + p.carry);
    cnt_in = reinterpret_cast<int*>(work + p.carry + slot);
    seen_in = reinterpret_cast<int*>(work + p.carry + 2 * slot);
    cudaError_t err = cudaMemcpyAsync(t0_in, t0, shards * sizeof(float),
                                      cudaMemcpyDeviceToDevice, stream);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(cnt_in, counts,
                            static_cast<size_t>(shards) * w * sizeof(int),
                            cudaMemcpyDeviceToDevice, stream);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(seen_in, seen, shards * sizeof(int),
                            cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return err;
  }
  if (p.warm > 0)
    ladder_warm<<<static_cast<unsigned>(shards) * p.warm, LADDER_THREADS, 0,
                  stream>>>(x, wmin, shard_len, N, p.warm, seen_in);
  ladder_scan<float, MinOp><<<shards, LADDER_THREADS, 0, stream>>>(
      wmin, t0, p.warm, t0_in);
  if (w <= 8)
    ladder_levels<8>(x, keep, t0, counts, seen, cur, shards, shard_len, N, w,
                     p, wmin, cnt, cnt_in, seen_in, stream);
  else
    ladder_levels<32>(x, keep, t0, counts, seen, cur, shards, shard_len, N, w,
                      p, wmin, cnt, cnt_in, seen_in, stream);
  return cudaGetLastError();
}

// The retired one-CTA-a-lane kernel, for holding the chunked scan against
// it; launched by no entry point of the package.
extern "C" int topn_det_pass1_serial(const float* x, uint8_t* keep, float* t0,
                                     int* counts, int* seen, int* cur,
                                     int shards, int shard_len, int N, int w,
                                     cudaStream_t stream) {
  if (w < 1 || w > TOPN_DET_MAX_W) return cudaErrorInvalidValue;
  topn_det_serial_kernel<<<shards, TOPN_DET_THREADS, 0, stream>>>(
      x, keep, t0, counts, seen, cur, shard_len, N, w);
  return cudaGetLastError();
}

extern "C" size_t rle_topn_det_workspace(int R, int w) {
  return rle_plan(R, w).total;
}

// The chunked run scan over R > 0 runs, one cooperative launch; work holds
// rle_topn_det_workspace bytes.
extern "C" int rle_topn_det(const float* rv, const int* rl, int* head,
                            int* tstar, int R, int N, int w,
                            unsigned char* work, cudaStream_t stream) {
  if (w < 1 || w > TOPN_DET_MAX_W || R < 1) return cudaErrorInvalidValue;
  const cudaError_t e =
      w <= 8 ? rle_launch<8>(rv, rl, head, tstar, R, N, w, work, stream)
             : rle_launch<32>(rv, rl, head, tstar, R, N, w, work, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The retired one-CTA run scan, for holding the chunked scan against it;
// launched by no entry point of the package.
extern "C" int rle_topn_det_serial(const float* rv, const int* rl, int* head,
                                   int* tstar, int R, int N, int w,
                                   cudaStream_t stream) {
  if (w < 1 || w > TOPN_DET_MAX_W) return cudaErrorInvalidValue;
  rle_topn_det_serial_kernel<<<1, TOPN_DET_THREADS, 0, stream>>>(
      rv, rl, head, tstar, R, N, w);
  return cudaGetLastError();
}
