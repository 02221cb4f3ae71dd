// The stable partition of a stream by (lane, row), shared by the row-parallel
// pass-1 walks of DISTINCT (distinct.cu), GROUP BY (groupby.cu) and TOP-N
// (topn.cu).
//
// A per-row cache (a d x w table whose row an entry picks from its key, or
// for TOP-N from its shard-local index, alone) makes a switch lane d
// independent chains: an entry reads and writes only its own row, and order
// matters only within a row. So the walks take the stream apart by segment
// g = lane * d + row, keeping stream order within each segment, and then
// walk every segment on its own warp. The row is hash_mod of the entry's
// 32 bits, or with kIdx of its shard-local index; the entry keeps its 32
// bits either way.
//
// The partition, for S lanes of shard_len entries:
//   1. rowpar_hist: a CTA takes a tile of `tile` entries of one lane, hashes
//      them and counts its rows (shared-memory bins, or global atomics when
//      d is too large for them), warp-aggregated with __match_any_sync. The
//      counts go to column `tile` of the [S * d][tiles_per_lane] matrix.
//   2. rowpar_scan: one exclusive scan of that matrix, flattened, with one
//      extra zero at the end, gives each tile its offset in each segment
//      (segment-major, then tile), and the total m at the end.
//   3. rowpar_starts: starts[g] = offset of segment g's first tile; starts
//      has S * d + 1 entries, the last m.
//   4. rowpar_scatter: each tile walks its entries in chunks of a block,
//      warp by warp in order (one barrier a warp), and each group of equal
//      rows in a warp (__match_any_sync) takes its offsets from the row's
//      running counter; ranks follow lane order, so every segment holds its
//      entries in stream order. It writes each entry as one 8- or 16-byte
//      struct: the key, an optional 32-bit payload and the entry's index,
//      whose sign bit marks an invalid (padding) entry.
// No sort: the partition is a counting sort on the segment, in one pass
// over the stream for the counts and one for the scatter.
//
// The query-axis partition (rowpar_partition_q) does the same for a wave
// of up to ROWPAR_MAX_Q queries over one stream, each with its own d and
// seed (core.batched): segment g = segbase[q] + lane * d[q] + row, with
// segbase[q] = S * (d[0] + ... + d[q - 1]), so query q's entries fill
// [q * m, (q + 1) * m) of the output. rowpar_hist_q and rowpar_scatter_q
// load each entry once and hash it once for each query of the wave; the
// shared-memory bins of a tile hold every query's rows when they fit. The
// count matrix keeps its 2^24-cell cap by growing the tile.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

#define ROWPAR_THREADS 256           // threads of a partition or walk block
#define ROWPAR_SMEM_BINS 12288       // rows whose counters fit in 48 KB
#define ROWPAR_SCAN_THREADS 1024
#define ROWPAR_SCAN_ITEMS 8
#define ROWPAR_SCAN_CHUNK (ROWPAR_SCAN_THREADS * ROWPAR_SCAN_ITEMS)
#define ROWPAR_INVALID 0x80000000u   // sign bit of an index: invalid entry
#define ROWPAR_FULL 0xFFFFFFFFu

struct RowparPlan {
  int shards;
  int shard_len;
  int d;
  int tile;
  int tiles_per_lane;
  long long cells;  // shards * d * tiles_per_lane counters, plus one
  uint32_t idx_off;  // kIdx: added to the shard-local index (mod 2^32)
};

// Tiles of at least 2048 entries, grown until the count matrix has at most
// 2^24 cells (64 MiB).
static inline RowparPlan rowpar_plan(int shards, int shard_len, int d) {
  RowparPlan p;
  p.shards = shards;
  p.shard_len = shard_len;
  p.d = d;
  int t = 2048;
  while (t < (1 << 20) &&
         static_cast<long long>(shards) * ((shard_len + t - 1) / t) * d >
             (1LL << 24))
    t *= 2;
  p.tile = t;
  p.tiles_per_lane = shard_len > 0 ? (shard_len + t - 1) / t : 1;
  p.cells = static_cast<long long>(shards) * d * p.tiles_per_lane + 1;
  p.idx_off = 0u;
  return p;
}

// A wave of the query-axis partition and of the batched walks, passed to
// the kernels by value. w, dcap and wcap are the walks' (each query's cache
// width, and the batch's padded state [Q][S][dcap][wcap]).
#define ROWPAR_MAX_Q 16
struct RowparQ {
  int nq;
  int shards;
  int shard_len;
  int tile;
  int tiles_per_lane;
  int dcap, wcap;
  long long nseg;   // S * (d[0] + ... + d[nq - 1]) segments
  long long cells;  // nseg * tiles_per_lane counters, plus one
  int d[ROWPAR_MAX_Q];
  int w[ROWPAR_MAX_Q];
  uint32_t seed[ROWPAR_MAX_Q];
  long long segbase[ROWPAR_MAX_Q + 1];
  int binbase[ROWPAR_MAX_Q + 1];  // d[0] + ... + d[q - 1]
};

static inline RowparQ rowpar_plan_q(int nq, int shards, int shard_len,
                                    const int* d, const int* w,
                                    const uint32_t* seed, int dcap,
                                    int wcap) {
  RowparQ p{};
  p.nq = nq;
  p.shards = shards;
  p.shard_len = shard_len;
  p.dcap = dcap;
  p.wcap = wcap;
  long long rows = 0;
  for (int q = 0; q < nq; ++q) {
    p.d[q] = d[q];
    p.w[q] = w ? w[q] : 0;
    p.seed[q] = seed[q];
    p.binbase[q] = static_cast<int>(rows);
    p.segbase[q] = rows * shards;
    rows += d[q];
  }
  p.binbase[nq] = static_cast<int>(rows);
  p.segbase[nq] = rows * shards;
  p.nseg = rows * shards;
  int t = 2048;
  while (t < (1 << 20) &&
         static_cast<long long>(shards) * ((shard_len + t - 1) / t) * rows >
             (1LL << 24))
    t *= 2;
  p.tile = t;
  p.tiles_per_lane = shard_len > 0 ? (shard_len + t - 1) / t : 1;
  p.cells = p.nseg * p.tiles_per_lane + 1;
  return p;
}

static inline long long rowpar_scan_blocks(long long n) {
  return (n + ROWPAR_SCAN_CHUNK - 1) / ROWPAR_SCAN_CHUNK;
}

static inline size_t rowpar_align(size_t b) { return (b + 255) & ~size_t(255); }

static inline size_t rowpar_partition_bytes_q(const RowparQ& p) {
  return rowpar_align(p.cells * sizeof(int)) +
         rowpar_align((rowpar_scan_blocks(p.cells) + 1) * sizeof(int)) +
         rowpar_align((p.nseg + 1) * sizeof(int));
}

// Bytes of the partition's own scratch: the count matrix, the scan's block
// partials and the segment starts.
static inline size_t rowpar_partition_bytes(const RowparPlan& p) {
  return rowpar_align(p.cells * sizeof(int)) +
         rowpar_align((rowpar_scan_blocks(p.cells) + 1) * sizeof(int)) +
         rowpar_align((static_cast<long long>(p.shards) * p.d + 1) *
                      sizeof(int));
}

namespace {

// Exclusive scan of one value per thread across the block; *total gets the
// block's sum. Uses 32 ints of shared memory; ends with a barrier.
__device__ __forceinline__ int rowpar_block_scan(int v, int* warp_sums,
                                                 int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(ROWPAR_FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(ROWPAR_FULL, s, off);
      if (lane >= off) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;  // inclusive
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void rowpar_scan_reduce(const int* __restrict__ a, long long n,
                                   int* __restrict__ partial) {
  __shared__ int ws[32];
  const long long base = static_cast<long long>(blockIdx.x) * ROWPAR_SCAN_CHUNK;
  int s = 0;
  for (int i = 0; i < ROWPAR_SCAN_ITEMS; ++i) {
    const long long j = base + static_cast<long long>(i) * blockDim.x + threadIdx.x;
    if (j < n) s += a[j];
  }
  int total;
  rowpar_block_scan(s, ws, &total);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// In-place exclusive scan of a[0, n) in rounds of blockDim.x, starting from
// carry0[blockIdx.x] (or 0) and covering `per_block` elements a block.
__global__ void rowpar_scan_apply(int* __restrict__ a, long long n,
                                  const int* __restrict__ carry0,
                                  long long per_block) {
  __shared__ int ws[32];
  const long long base = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = min(n, base + per_block);
  int carry = carry0 ? carry0[blockIdx.x] : 0;
  for (long long r = base; r < end; r += blockDim.x) {
    const long long j = r + threadIdx.x;
    const int v = j < end ? a[j] : 0;
    int total;
    const int ex = rowpar_block_scan(v, ws, &total);
    if (j < end) a[j] = carry + ex;
    carry += total;
  }
}

// kIdx: the row is hashed from the shard-local index t * tile + i plus
// p.idx_off (a resumed TOP-N scan's offset), not from the entry's bits.
template <bool kSmem, bool kIdx>
__global__ void rowpar_hist(const uint32_t* __restrict__ x,
                            int* __restrict__ cells, RowparPlan p,
                            uint32_t seed) {
  extern __shared__ int bins[];
  const int s = blockIdx.x / p.tiles_per_lane;
  const int t = blockIdx.x % p.tiles_per_lane;
  const long long base =
      static_cast<long long>(s) * p.shard_len + static_cast<long long>(t) * p.tile;
  const int n = min(p.tile, p.shard_len - t * p.tile);
  int* col = cells + static_cast<long long>(s) * p.d * p.tiles_per_lane + t;
  if (kSmem) {
    for (int r = threadIdx.x; r < p.d; r += blockDim.x) bins[r] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool in = i < n;
    const unsigned active = __ballot_sync(ROWPAR_FULL, in);
    if (in) {
      const uint32_t key =
          kIdx ? static_cast<uint32_t>(t * p.tile + i) + p.idx_off
               : x[base + i];
      const int r = cheetah_hash_mod(key, p.d, seed);
      const unsigned peers = __match_any_sync(active, r);
      if (lane == __ffs(peers) - 1) {
        if (kSmem)
          atomicAdd(&bins[r], __popc(peers));
        else
          atomicAdd(&col[static_cast<long long>(r) * p.tiles_per_lane],
                    __popc(peers));
      }
    }
  }
  if (kSmem) {
    __syncthreads();
    for (int r = threadIdx.x; r < p.d; r += blockDim.x)
      col[static_cast<long long>(r) * p.tiles_per_lane] = bins[r];
  }
}

__global__ void rowpar_starts(const int* __restrict__ cells,
                              int* __restrict__ starts, long long nseg,
                              int tiles_per_lane) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g <= nseg) starts[g] = cells[g * tiles_per_lane];
}

// The query-axis histogram: a CTA a tile of a lane, each entry loaded once
// and hashed with each query's d and seed.
template <bool kSmem, bool kIdx>
__global__ void rowpar_hist_q(const uint32_t* __restrict__ x,
                              int* __restrict__ cells, RowparQ p) {
  extern __shared__ int bins[];
  const int s = blockIdx.x / p.tiles_per_lane;
  const int t = blockIdx.x % p.tiles_per_lane;
  const long long base =
      static_cast<long long>(s) * p.shard_len + static_cast<long long>(t) * p.tile;
  const int n = min(p.tile, p.shard_len - t * p.tile);
  if (kSmem) {
    for (int r = threadIdx.x; r < p.binbase[p.nq]; r += blockDim.x) bins[r] = 0;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool in = i < n;
    const unsigned active = __ballot_sync(ROWPAR_FULL, in);
    const uint32_t key =
        !in ? 0u : kIdx ? static_cast<uint32_t>(t * p.tile + i) : x[base + i];
    for (int q = 0; q < p.nq; ++q) {
      if (!in) continue;
      const int r = cheetah_hash_mod(key, p.d[q], p.seed[q]);
      const unsigned peers = __match_any_sync(active, r);
      if (lane == __ffs(peers) - 1) {
        if (kSmem)
          atomicAdd(&bins[p.binbase[q] + r], __popc(peers));
        else
          atomicAdd(&cells[(p.segbase[q] + static_cast<long long>(s) * p.d[q] + r) *
                               p.tiles_per_lane + t],
                    __popc(peers));
      }
    }
  }
  if (kSmem) {
    __syncthreads();
    for (int q = 0; q < p.nq; ++q)
      for (int r = threadIdx.x; r < p.d[q]; r += blockDim.x)
        cells[(p.segbase[q] + static_cast<long long>(s) * p.d[q] + r) *
                  p.tiles_per_lane + t] = bins[p.binbase[q] + r];
  }
}

// One entry of the partitioned stream: (key, index) or (key, payload,
// index, 0), one store each, so that a scattered entry dirties one sector.
__device__ __forceinline__ void rowpar_put(uint2* out, int pos, uint32_t k,
                                           const uint32_t*, long long,
                                           uint32_t idx) {
  out[pos] = make_uint2(k, idx);
}

__device__ __forceinline__ void rowpar_put(uint4* out, int pos, uint32_t k,
                                           const uint32_t* aux, long long e,
                                           uint32_t idx) {
  out[pos] = make_uint4(k, aux[e], idx, 0u);
}

// ok: validity bytes or nullptr (all valid); aux: the payload of a uint4
// entry (E = uint2 has none).
template <bool kSmem, bool kIdx, typename E>
__global__ void rowpar_scatter(const uint32_t* __restrict__ x,
                               const uint32_t* __restrict__ aux,
                               const uint8_t* __restrict__ ok,
                               int* __restrict__ cells, RowparPlan p,
                               uint32_t seed, E* __restrict__ out) {
  extern __shared__ int off[];
  const int s = blockIdx.x / p.tiles_per_lane;
  const int t = blockIdx.x % p.tiles_per_lane;
  const long long base =
      static_cast<long long>(s) * p.shard_len + static_cast<long long>(t) * p.tile;
  const int n = min(p.tile, p.shard_len - t * p.tile);
  int* col = cells + static_cast<long long>(s) * p.d * p.tiles_per_lane + t;
  if (kSmem) {
    for (int r = threadIdx.x; r < p.d; r += blockDim.x)
      off[r] = col[static_cast<long long>(r) * p.tiles_per_lane];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool in = i < n;
    const unsigned active = __ballot_sync(ROWPAR_FULL, in);
    uint32_t v = 0;
    int r = 0, rank = 0, leader = 0;
    unsigned peers = 0;
    if (in) {
      v = x[base + i];
      r = cheetah_hash_mod(
          kIdx ? static_cast<uint32_t>(t * p.tile + i) + p.idx_off : v, p.d,
          seed);
      peers = __match_any_sync(active, r);
      rank = __popc(peers & ((1u << lane) - 1u));
      leader = __ffs(peers) - 1;
    }
    int pos = 0;
    // warps in order, so that a row's ranks follow stream order
    for (int wv = 0; wv < nwarps; ++wv) {
      if (warp == wv) {
        int b = 0;
        if (in && lane == leader) {
          int* c = kSmem ? &off[r] : &col[static_cast<long long>(r) * p.tiles_per_lane];
          b = *c;
          *c = b + __popc(peers);
        }
        pos = __shfl_sync(ROWPAR_FULL, b, leader) + rank;
      }
      __syncthreads();
    }
    if (in) {
      const long long e = base + i;
      rowpar_put(out, pos, v, aux, e,
                 static_cast<uint32_t>(e) | (ok && !ok[e] ? ROWPAR_INVALID : 0u));
    }
  }
}

// The query-axis scatter: as rowpar_scatter, each entry loaded once and
// placed once for each query of the wave (query q's segments start at
// segbase[q], so its entries land in [q * m, (q + 1) * m)).
template <bool kSmem, bool kIdx, typename E>
__global__ void rowpar_scatter_q(const uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ aux,
                                 const uint8_t* __restrict__ ok,
                                 int* __restrict__ cells, RowparQ p,
                                 E* __restrict__ out) {
  extern __shared__ int off[];
  const int s = blockIdx.x / p.tiles_per_lane;
  const int t = blockIdx.x % p.tiles_per_lane;
  const long long base =
      static_cast<long long>(s) * p.shard_len + static_cast<long long>(t) * p.tile;
  const int n = min(p.tile, p.shard_len - t * p.tile);
  if (kSmem) {
    for (int q = 0; q < p.nq; ++q)
      for (int r = threadIdx.x; r < p.d[q]; r += blockDim.x)
        off[p.binbase[q] + r] =
            cells[(p.segbase[q] + static_cast<long long>(s) * p.d[q] + r) *
                      p.tiles_per_lane + t];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool in = i < n;
    const unsigned active = __ballot_sync(ROWPAR_FULL, in);
    const long long e = base + i;
    const uint32_t v = in ? x[e] : 0u;
    const uint32_t idx =
        static_cast<uint32_t>(e) | (in && ok && !ok[e] ? ROWPAR_INVALID : 0u);
    const uint32_t key = kIdx ? static_cast<uint32_t>(t * p.tile + i) : v;
    for (int q = 0; q < p.nq; ++q) {
      int r = 0, rank = 0, leader = 0;
      unsigned peers = 0;
      if (in) {
        r = cheetah_hash_mod(key, p.d[q], p.seed[q]);
        peers = __match_any_sync(active, r);
        rank = __popc(peers & ((1u << lane) - 1u));
        leader = __ffs(peers) - 1;
      }
      int pos = 0;
      // warps in order, so that a row's ranks follow stream order
      for (int wv = 0; wv < nwarps; ++wv) {
        if (warp == wv) {
          int b = 0;
          if (in && lane == leader) {
            int* c = kSmem ? &off[p.binbase[q] + r]
                           : &cells[(p.segbase[q] + static_cast<long long>(s) * p.d[q] + r) *
                                        p.tiles_per_lane + t];
            b = *c;
            *c = b + __popc(peers);
          }
          pos = __shfl_sync(ROWPAR_FULL, b, leader) + rank;
        }
        __syncthreads();
      }
      if (in) rowpar_put(out, pos, v, aux, e, idx);
    }
  }
}

// The walks load their segment through a ring of ROWPAR_STAGES chunks of 32
// entries a warp in shared memory, filled by cp.async ROWPAR_STAGES - 1
// chunks ahead of the chunk being walked: a long segment's chain of steps
// is not held up by load latency. Each lane copies and reads only its own
// element of a chunk, so no warp barrier is needed.
#define ROWPAR_STAGES 8
#define ROWPAR_WARPS (ROWPAR_THREADS / 32)

// Copy one entry of N bytes (8 or 16) to shared memory; zeros when !pred.
template <int N>
__device__ __forceinline__ void rowpar_cp(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(pred ? N : 0));
}

__device__ __forceinline__ void rowpar_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's copy groups are in flight (groups
// complete in order).
template <int N>
__device__ __forceinline__ void rowpar_wait_for() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Wait until chunk c of the ring has landed, chunk c + STAGES - 1 being the
// last one issued.
__device__ __forceinline__ void rowpar_wait() {
  rowpar_wait_for<ROWPAR_STAGES - 1>();
}

__device__ __forceinline__ void rowpar_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Rows wider than the register walks take (w > 32) live in shared memory,
// one row a warp: the warps of a block of such a walk for rows of
// row_bytes, or 0 when one row does not fit.
static inline int rowpar_wide_warps(size_t row_bytes) {
  const size_t fit = CHEETAH_MAX_SMEM / row_bytes;
  return fit >= ROWPAR_WARPS ? ROWPAR_WARPS : static_cast<int>(fit);
}

// The first of a shared-memory row's w slots that is valid and holds v, or
// w when none: the warp probes the row lane-strided and takes a warp min.
__device__ __forceinline__ int rowpar_first_hit(const uint32_t* s,
                                                const uint8_t* valid, int w,
                                                uint32_t v, int lane) {
  unsigned first = static_cast<unsigned>(w);
  for (int i = lane; i < w; i += 32)
    if (valid[i] && s[i] == v) {
      first = static_cast<unsigned>(i);
      break;
    }
  return static_cast<int>(__reduce_min_sync(ROWPAR_FULL, first));
}

// Slots 1..lim of a shared-memory row take slots 0..lim-1, the warp moving
// 32 slots at a time from the top, so that each is read before it is
// overwritten.
template <typename T>
__device__ __forceinline__ void rowpar_shift(T* a, int lim, int lane) {
  for (int b = (lim >> 5) << 5; b >= 0; b -= 32) {
    const int i = b + lane;
    const bool move = i >= 1 && i <= lim;
    T t{};
    if (move) t = a[i - 1];
    __syncwarp();
    if (move) a[i] = t;
    __syncwarp();
  }
}

// In-place exclusive scan of n ints at a, using `partial` (room for
// rowpar_scan_blocks(n) + 1 ints).
static inline cudaError_t rowpar_scan(int* a, long long n, int* partial,
                                      cudaStream_t stream) {
  const long long nb = rowpar_scan_blocks(n);
  rowpar_scan_reduce<<<static_cast<unsigned>(nb), ROWPAR_SCAN_THREADS, 0, stream>>>(
      a, n, partial);
  rowpar_scan_apply<<<1, ROWPAR_SCAN_THREADS, 0, stream>>>(partial, nb,
                                                           nullptr, nb);
  rowpar_scan_apply<<<static_cast<unsigned>(nb), ROWPAR_SCAN_THREADS, 0, stream>>>(
      a, n, partial, ROWPAR_SCAN_CHUNK);
  return cudaGetLastError();
}

template <bool kIdx, typename E>
cudaError_t rowpar_partition_by(const uint32_t* x, const uint32_t* aux,
                                const uint8_t* ok, const RowparPlan& p,
                                uint32_t seed, E* out, unsigned char* work,
                                int** starts, cudaStream_t stream) {
  int* cells = reinterpret_cast<int*>(work);
  work += rowpar_align(p.cells * sizeof(int));
  int* partial = reinterpret_cast<int*>(work);
  work += rowpar_align((rowpar_scan_blocks(p.cells) + 1) * sizeof(int));
  *starts = reinterpret_cast<int*>(work);
  const long long nseg = static_cast<long long>(p.shards) * p.d;
  const unsigned tiles = static_cast<unsigned>(p.shards) * p.tiles_per_lane;
  const bool smem = p.d <= ROWPAR_SMEM_BINS;
  const size_t bins = smem ? static_cast<size_t>(p.d) * sizeof(int) : 0;
  cudaError_t err = cudaMemsetAsync(cells, 0, p.cells * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (smem)
    rowpar_hist<true, kIdx><<<tiles, ROWPAR_THREADS, bins, stream>>>(x, cells, p, seed);
  else
    rowpar_hist<false, kIdx><<<tiles, ROWPAR_THREADS, 0, stream>>>(x, cells, p, seed);
  err = rowpar_scan(cells, p.cells, partial, stream);
  if (err != cudaSuccess) return err;
  rowpar_starts<<<static_cast<unsigned>((nseg + 1 + 255) / 256), 256, 0, stream>>>(
      cells, *starts, nseg, p.tiles_per_lane);
  if (smem)
    rowpar_scatter<true, kIdx, E><<<tiles, ROWPAR_THREADS, bins, stream>>>(
        x, aux, ok, cells, p, seed, out);
  else
    rowpar_scatter<false, kIdx, E><<<tiles, ROWPAR_THREADS, 0, stream>>>(
        x, aux, ok, cells, p, seed, out);
  return cudaGetLastError();
}

// Partition the lanes of x into segments of E entries at out; returns the
// segment starts (S * d + 1 ints) through *starts. work holds
// rowpar_partition_bytes(p). by_index: the row comes from the shard-local
// index (TOP-N), not from the entry's bits.
template <typename E>
cudaError_t rowpar_partition(const uint32_t* x, const uint32_t* aux,
                             const uint8_t* ok, const RowparPlan& p,
                             uint32_t seed, E* out, unsigned char* work,
                             int** starts, cudaStream_t stream,
                             bool by_index = false) {
  return by_index ? rowpar_partition_by<true>(x, aux, ok, p, seed, out, work,
                                              starts, stream)
                  : rowpar_partition_by<false>(x, aux, ok, p, seed, out, work,
                                               starts, stream);
}

// Partition the lanes of x into every query's segments of E entries at
// out (nq * m entries); *starts gets the nseg + 1 segment starts. work
// holds rowpar_partition_bytes_q(p). by_index as rowpar_partition.
template <typename E>
cudaError_t rowpar_partition_q(const uint32_t* x, const uint32_t* aux,
                               const uint8_t* ok, const RowparQ& p, E* out,
                               unsigned char* work, int** starts,
                               cudaStream_t stream, bool by_index = false) {
  int* cells = reinterpret_cast<int*>(work);
  work += rowpar_align(p.cells * sizeof(int));
  int* partial = reinterpret_cast<int*>(work);
  work += rowpar_align((rowpar_scan_blocks(p.cells) + 1) * sizeof(int));
  *starts = reinterpret_cast<int*>(work);
  const unsigned tiles = static_cast<unsigned>(p.shards) * p.tiles_per_lane;
  const bool smem = p.binbase[p.nq] <= ROWPAR_SMEM_BINS;
  const size_t bins = smem ? static_cast<size_t>(p.binbase[p.nq]) * sizeof(int) : 0;
  cudaError_t err = cudaMemsetAsync(cells, 0, p.cells * sizeof(int), stream);
  if (err != cudaSuccess) return err;
#define CHEETAH_Q(K, I)                                                        \
  rowpar_hist_q<K, I><<<tiles, ROWPAR_THREADS, bins, stream>>>(x, cells, p)
  if (smem && by_index) CHEETAH_Q(true, true);
  else if (smem) CHEETAH_Q(true, false);
  else if (by_index) CHEETAH_Q(false, true);
  else CHEETAH_Q(false, false);
#undef CHEETAH_Q
  err = rowpar_scan(cells, p.cells, partial, stream);
  if (err != cudaSuccess) return err;
  rowpar_starts<<<static_cast<unsigned>((p.nseg + 1 + 255) / 256), 256, 0, stream>>>(
      cells, *starts, p.nseg, p.tiles_per_lane);
#define CHEETAH_Q(K, I)                                                        \
  rowpar_scatter_q<K, I, E><<<tiles, ROWPAR_THREADS, bins, stream>>>(          \
      x, aux, ok, cells, p, out)
  if (smem && by_index) CHEETAH_Q(true, true);
  else if (smem) CHEETAH_Q(true, false);
  else if (by_index) CHEETAH_Q(false, true);
  else CHEETAH_Q(false, false);
#undef CHEETAH_Q
  return cudaGetLastError();
}

// The segment g of a wave: its query, lane and row.
__device__ __forceinline__ void rowpar_segment_q(const RowparQ& p, long long g,
                                                 int* q, int* lane, int* row) {
  int k = 0;
  while (k + 1 < p.nq && g >= p.segbase[k + 1]) ++k;
  const long long local = g - p.segbase[k];
  *q = k;
  *lane = static_cast<int>(local / p.d[k]);
  *row = static_cast<int>(local % p.d[k]);
}

// The padded state's first slot of (query, lane, row): [Q][S][dcap][wcap].
__device__ __forceinline__ long long rowpar_slot_q(const RowparQ& p, int q,
                                                   int lane, int row) {
  return ((static_cast<long long>(q) * p.shards + lane) * p.dcap + row) *
         p.wcap;
}

}  // namespace
