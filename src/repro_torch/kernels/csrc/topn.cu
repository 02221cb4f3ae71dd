// Randomized TOP-N pruning (paper Ex. 7) on Hopper: pass 1 and pass 2.
//
// topn_pass1 replaces two pallas_calls of the JAX package:
//   topn_prune_kernel         src/repro/kernels/topn_prune.py:49  (S = 1)
//   topn_shard_states_kernel  src/repro/kernels/parallel.py:86    (S shards)
// and, at B = 1, the engine's per-entry scan core.topn.topn_rand_prune
// (src/repro/core/topn.py:38-69, a lax.scan): keep = x >= row[w - 1], and
// the row takes a sorted insert when x > row[w - 1] (pos = #(x <= row)).
//
// Block semantics as in src/repro/kernels/ref.py (B = 1 is the scan):
// every keep of a block of B entries of a lane reads the row as it stood
// before the block, and each row takes one sorted insert per block, its
// candidate: the scatter max of the block's entries of that row, NaN if
// any of them is a NaN of either sign (no insert follows), else the
// largest with +0 above -0 (topn_cand_ord: the order-preserving integer
// image, every NaN on top). At B = 1 the candidate is the entry itself.
// Compares flush f32 subnormals, as XLA's do (--ftz=true, hash.cuh); at
// B > 1 so does the candidate, XLA's maximum, whose integer image is taken
// of the flushed value, while at B = 1 the row takes the entry's bits, as
// the scan's select does (ROADMAP Queue 3 A25).
//
// The row-parallel walk (topn_pass1 at B = 1, topn_pass1_block_walk at any
// B). An entry reads and writes only its row, hash_mod(shard-local index,
// d, seed), so a lane is d independent chains, per block. The stable
// partition of rowpar.cuh, by index (each entry keeps its value's 32 bits
// and its index), puts each segment (lane, row) in stream order, so that
// a block's entries of the row (a group; block id = shard-local index / B)
// are contiguous. topn_walk then takes one warp a segment, its entries 32
// at a time through the cp.async ring of rowpar.cuh, the row's w <= 32
// values in registers (slot j on lane j). At B > 1 (topn_block_window), a
// segmented max by shuffles gives every group's candidate in a window and
// a ballot marks the group ends; a step inserts the first ending group
// whose candidate beats the row's minimum (its slots after pos move up by
// a shuffle), after the entries up to it keep iff value >= minimum, and
// the step repeats past it. The window's last group stays open and
// carries its running candidate into the next window (at d = 1 a group is
// all B entries of a block). At B = 1 (topn_window) a step is one ballot
// over the entries themselves, with no scan: the block window gives the
// same bits there, but slower on the main path's column (PERF.md). Most
// steps see no insert: the matrix takes about a hundred inserts a row on
// the main path. Rows of w > 32 take topn_walk_wide: the same steps on a
// row in shared memory. What bounds the walk: bytes (the partition reads
// x twice and writes 8 bytes an entry; the walk reads them and scatters
// keep), not its chain, the costliest segment's inserting groups.
//
// topn_pass1_batch carries a wave of queries (core.batched): the
// query-axis partition of rowpar.cuh, then topn_walk_q, one warp a (query,
// lane, row) segment with its query's w, into the batch's padded state.
//
// A resumed walk (B = 1: the streaming fold, core.streaming) hashes the
// shard-local index plus idx_off (the entries the lane has consumed, mod
// 2^32; rowpar.cuh's partition and the apply add it alike) and starts each
// (lane, row) from the row ``states`` holds, which its warp reads before
// anything else and writes back at its end (in place).
//
// topn_pass1 at B > 1 is topn_pass1_block, one CTA a lane with its
// f32[d][w] matrix in shared memory: a chunk's keeps read the pre-chunk
// matrix, and each row's candidate is a shared atomicMax on topn_cand_ord
// by the entries that can matter (above the row minimum, or NaN), whose
// owner (a compare-and-swap of the candidate back to 0) does the sorted
// insert; no pass over the d rows. The stream comes through the cp.async
// ring of staged.cuh, stages ahead of the chain, and is fetched two chunks
// ahead; the next chunk's row (a hash of the shard-local index alone) is
// computed while the step's loads are in flight. Its chain is shard_len / B
// steps of two barriers, on one SM a lane, so it is the faster form only
// when the lanes fill enough of the card (kernels/parallel.py,
// use_block_walk). At S = 1 it is reached only through its C entry, which
// chip_smoke.py holds the walk against at full size. What a step costs:
// the B entries' instructions and shared-memory operations on one SM of 8
// warps, and on the main path's lanes the owners' inserts, which come
// almost every step; not device memory, which the ring keeps off the
// chain (PERF.md).
//
// The kernels' family (ops.topn_prune, ops.topn_prune_parallel; the Pallas
// kernels) reads an entry's row minimum by a one-hot product over the d
// minima, so once a row's minimum is +inf every other row reads NaN and
// keeps nothing, and once two rows' are, no row keeps (ROADMAP Queue 3
// A27). Every form of pass 1 keeps by the direct read and, in that family,
// writes tinf, the block of each row's last insert (a row whose minimum is
// +inf took its last insert then); topn_onehot_fixup then rewrites the
// keep of the blocks after the first such block of a lane. On a column
// without +inf it reads each lane's d minima and returns. The engine's
// family (B = 1, the reference's lax.scan) reads the minimum itself and
// passes no tinf.
//
// topn_pass1_block_unstaged is the block kernel it replaced (each step
// loaded its entry from device memory, bid every entry's order into a
// candidate and passed over all d rows for the inserts). No entry point of
// the package launches it; chip_smoke.py holds the staged kernel against
// it at full size.
//
// topn_pass1_serial is the kernel the walk replaced at B = 1 (one thread
// of a CTA walks its lane's entries in order). No entry point of the
// package launches it; chip_smoke.py holds the walk against it at full
// size.
//
// topn_apply replaces topn_apply_kernel (src/repro/kernels/parallel.py:126):
// keep[s * L + j] = x[s * L + j] >= read(rowmin, hash_mod(j, d, seed)) over
// the S shards of L entries, rowmin being column w - 1 of the merged [d, w]
// matrix, read in place by its row stride, and the compare setp.ge.ftz.f32
// (A25). Two families of read (A26): the kernels' (ops.topn_prune_parallel)
// is the Pallas kernel's one-hot product, so a row reads NaN when another
// row's minimum is not finite or its own is NaN (ROADMAP B15), else its
// minimum; the engine's (two_pass) reads the minimum itself. It is bound by
// bytes: 4 read and 1 written an entry. The row depends on j alone, the
// same in every shard, so a thread owns 4 consecutive j, hashes them and
// reads their minima once (from shared memory, where each CTA stages the
// column and counts its non-finite minima), then walks its group of shards
// with one 16-byte load of x and one 4-byte store of keep a shard: the hash
// and the modulo are paid once for S entries, not once an entry. The keep
// mask lies at x's offset mod 16 (kernels/common.py, query_out), so a quad
// of x on 16 bytes is a word of keep. Shards that start off 16 bytes
// (L % 4 != 0, or x a view at any 4-byte offset) shift each thread's quad
// to the shard's 16-byte grid (7 minima a thread), with the head and the
// tail scalar. The grid is one wave of resident CTAs (topn_apply_plan):
// the quads of a shard across blockIdx.x, groups of shards across
// blockIdx.y.
//
// topn_apply_grid is the apply it replaced (one thread an entry in a
// grid-stride loop, a 64-bit modulo and a hash an entry, the engine's read
// of a contiguous copy of the column). No entry point of the package
// launches it; chip_smoke.py holds the new apply against it at full size.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hash.cuh"
#include "rowpar.cuh"
#include "staged.cuh"

namespace {

// Sorted insert into a descending row of w values; the caller has checked
// c > row[w - 1], so the position is < w (ref.py: pos = count(c <= row)).
__device__ __forceinline__ void insert_sorted(float* row, int w, float c) {
  int pos = 0;
  for (int j = 0; j < w; ++j) pos += (c <= row[j]);
  for (int j = w - 1; j > pos; --j) row[j] = row[j - 1];
  row[pos] = c;
}

__global__ void topn_pass1_serial_kernel(const float* __restrict__ x,
                                         uint8_t* __restrict__ keep,
                                         float* __restrict__ states,
                                         int shard_len, int d, int w,
                                         uint32_t seed) {
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

// The order of an entry in its block's candidate: the order-preserving
// image of v (-0 below +0), every NaN of either sign above all, so that a
// block holding a NaN yields a NaN and inserts nothing (ref.py's scatter max
// propagates any NaN; cheetah_ordered puts a negative NaN at the bottom).
__device__ __forceinline__ unsigned topn_cand_ord(float v) {
  return v != v ? 0xFFFFFFFFu : cheetah_ordered(v);
}

// The retired block kernel (see the header); blockDim.x == block.
__global__ void topn_pass1_block_unstaged_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ keep,
    float* __restrict__ states, int shard_len, int d, int w, uint32_t seed) {
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
    atomicMax(&cand[row], topn_cand_ord(v));
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

// The quad of slots i .. i+3 of a row after the sorted insert of c at pos:
// slots before pos stay, slot pos takes c, the later ones take the slot
// before them (``before``: slot i - 1 as it was).
__device__ __forceinline__ float4 insert_quad(float4 a, float before, int i,
                                              int pos, float c) {
  float4 o;
  o.x = i < pos ? a.x : (i == pos ? c : before);
  o.y = i + 1 < pos ? a.y : (i + 1 == pos ? c : a.x);
  o.z = i + 2 < pos ? a.z : (i + 2 == pos ? c : a.y);
  o.w = i + 3 < pos ? a.w : (i + 3 == pos ? c : a.z);
  return o;
}

__device__ __forceinline__ int quad_le(float c, float4 a) {
  return (c <= a.x) + (c <= a.y) + (c <= a.z) + (c <= a.w);
}

// Sorted insert as insert_sorted, 16 bytes at a time: w % 4 == 0 and the
// row 16-byte aligned. A row of 8 (the main path's) is loaded once, both
// quads at a time, and written back from registers: the insert is on the
// step's chain almost every step there (PERF.md has the block kernel's time
// with and without this path). A wider row takes a pass over the quads for
// pos and one over the quads from pos on.
__device__ __forceinline__ void insert_sorted4(float* row, int w, float c) {
  float4* q = reinterpret_cast<float4*>(row);
  if (w == 8) {
    const float4 a = q[0];
    const float4 b = q[1];
    const int pos = quad_le(c, a) + quad_le(c, b);
    q[0] = insert_quad(a, c, 0, pos, c);
    q[1] = insert_quad(b, a.w, 4, pos, c);
    return;
  }
  const int nq = w >> 2;
  int pos = 0;
  for (int k = 0; k < nq; ++k) pos += quad_le(c, q[k]);
  float before = c;
  for (int k = pos >> 2; k < nq; ++k) {
    const float4 a = q[k];
    q[k] = insert_quad(a, before, k << 2, pos, c);
    before = a.w;
  }
}

// The block kernel (B > 1), one CTA a lane, blockDim.x == block: thread t
// takes entry t of every chunk of B entries. Its f32[d][w] matrix and a
// candidate a row are in shared memory; its stream comes through the ring
// of staged.cuh, fetched two chunks ahead. A step (one chunk): the entry
// keeps against the row minimum as it stood before the chunk (a byte
// stored straight to keep, 32 consecutive bytes a warp); an entry above
// that minimum, or a NaN, bids a shared atomicMax of topn_cand_ord into
// the row's candidate (the block's maximum of a row is a bid whenever it
// beats the minimum or is a NaN, the only cases that matter); the row of
// the next chunk (a hash of the shard-local index alone) and the value of
// the one after it are fetched while that runs; a barrier; the bidder whose
// compare-and-swap takes the row's candidate back to 0 owns the row (one of
// equal bidders, whose values have equal bits) and inserts its value when
// it beats the minimum it read (a NaN never does); a barrier. Once the rows
// have filled few entries bid: a step is then the keep's shared load of
// the row minimum, and the B entries' shared-memory traffic on one SM, not
// one entry's latency, sets its time. kTinf (the kernels' family): the
// owner also records the chunk at which its row's minimum became +inf; a
// template argument, since the same check made at run time on a null tinf
// cost the engine's family 11 % on the device (PERF.md).
template <bool kTinf>
__global__ void __launch_bounds__(1024)
    topn_pass1_block(const float* __restrict__ x, uint8_t* __restrict__ keep,
                     float* __restrict__ states, int shard_len, int d, int w,
                     uint32_t seed, int cps, int stages, int ring_off,
                     int slot, unsigned* __restrict__ tinf) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);
  unsigned* cand = reinterpret_cast<unsigned*>(st + d * w);
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  const int nchunks = shard_len / B;
  StagedRing ring{reinterpret_cast<const uint32_t*>(x) + base,
                  reinterpret_cast<uint32_t*>(smem + ring_off),
                  t, B, cps, stages, nchunks, static_cast<size_t>(slot)};
  for (int i = t; i < d * w; i += B) st[i] = cheetah_neg_value();
  for (int r = t; r < d; r += B) cand[r] = 0u;  // below every entry's order
  ring.start();
  const bool quads = (w & 3) == 0;
  int row = cheetah_hash_mod(static_cast<uint32_t>(t), d, seed);
  __syncthreads();
  float v = __uint_as_float(ring.first());
  float v1 = nchunks > 1 ? __uint_as_float(ring.next()) : 0.0f;
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    float* rowp = st + row * w;
    const float rmin = rowp[w - 1];
    const int row1 =
        cheetah_hash_mod(static_cast<uint32_t>((c + 1) * B + t), d, seed);
    const float v2 = c + 2 < nchunks ? __uint_as_float(ring.next()) : 0.0f;
    v = cheetah_ftz(v);  // XLA's maximum flushes the candidate
    keep[base + static_cast<long long>(c) * B + t] = v >= rmin;
    const bool bid = !(v <= rmin);
    const unsigned o = topn_cand_ord(v);
    if (bid) atomicMax(&cand[row], o);
    __syncthreads();
    // a bidder below the candidate, or after the owner's swap, swaps nothing
    if (bid && atomicCAS(&cand[row], o, 0u) == o && v > rmin) {
      if (quads)
        insert_sorted4(rowp, w, v);
      else
        insert_sorted(rowp, w, v);
      if (kTinf && __float_as_uint(rowp[w - 1]) == 0x7F800000u)
        tinf[static_cast<long long>(blockIdx.x) * d + row] = c;
    }
    __syncthreads();
    v = v1;
    v1 = v2;
    row = row1;
  }
  rowpar_wait_all();
  float* out = states + static_cast<long long>(blockIdx.x) * d * w;
  for (int i = t; i < d * w; i += B) out[i] = st[i];
}

// A walk's row in registers (w <= 32): slot j is lane j's r; rmin is slot
// w - 1 on every lane. insert(c) is the sorted insert of c > rmin at
// pos = #(c <= row), the slots after pos moving up by a shuffle.
struct TopnRegRow {
  float r, rmin;
  __device__ __forceinline__ TopnRegRow()
      : r(cheetah_neg_value()), rmin(cheetah_neg_value()) {}
  __device__ __forceinline__ void insert(float c, int w, int lane) {
    const int pos = __popc(__ballot_sync(ROWPAR_FULL, lane < w && c <= r));
    const float up = __shfl_up_sync(ROWPAR_FULL, r, 1);
    if (lane == pos)
      r = c;
    else if (lane > pos && lane < w)
      r = up;
    rmin = __shfl_sync(ROWPAR_FULL, r, w - 1);
  }
};

// A walk's row in shared memory (w > 32), one warp's w slots at s: an
// insert counts pos lane-strided and shifts the row.
struct TopnSmemRow {
  float* s;
  float rmin;
  __device__ __forceinline__ void insert(float c, int w, int lane) {
    unsigned cnt = 0;
    for (int i = lane; i < w; i += 32) cnt += c <= s[i];
    const int pos = static_cast<int>(__reduce_add_sync(ROWPAR_FULL, cnt));
    rowpar_shift(s + pos, w - 1 - pos, lane);
    if (lane == 0) s[pos] = c;
    __syncwarp();
    rmin = s[w - 1];
  }
};

// The (row, block) group of a block walk that the last window left open:
// its block id and the order of its running candidate (topn_cand_ord).
struct TopnGroup {
  bool open;
  unsigned blk, ord;
};

// Close an open group: the row takes its candidate when that beats the
// row's minimum (a NaN never does).
template <typename Row>
__device__ __forceinline__ void topn_close(Row& row, TopnGroup& g, int w,
                                           int lane, unsigned& tl) {
  if (g.open) {
    const float c = cheetah_unordered(g.ord);
    if (c > row.rmin) {
      row.insert(c, w, lane);
      tl = g.blk;
    }
    g.open = false;
  }
}

// One window of n <= 32 entries of a B = 1 walk, entry e on lane e < n: a
// step is one ballot; the first entry whose value beats the row's minimum
// inserts, the entries before it keep iff value >= minimum, and the step
// repeats from the next entry. tl: the block (here the shard-local index)
// of the row's last insert.
template <typename Row>
__device__ __forceinline__ void topn_window(Row& row, uint2 e, int n, int w,
                                            int lane, int shard_len,
                                            unsigned& tl,
                                            uint8_t* __restrict__ keep) {
  const float v = __uint_as_float(e.x);
  bool kp = false;
  for (int done = 0;;) {
    const bool open = lane >= done && lane < n;
    const unsigned ins = __ballot_sync(ROWPAR_FULL, open && v > row.rmin);
    const int first = ins ? __ffs(ins) - 1 : n;
    if (open && lane < first) kp = v >= row.rmin;
    if (first == n) break;
    row.insert(__shfl_sync(ROWPAR_FULL, v, first), w, lane);
    tl = __shfl_sync(ROWPAR_FULL, e.y, first) %
         static_cast<unsigned>(shard_len);
    if (lane == first) kp = true;
    done = first + 1;
  }
  if (lane < n) keep[e.y] = kp;
}

// One window of n <= 32 entries of a block walk (B > 1), entry e on lane
// e < n. Its block id is its shard-local index / B, and a block's entries
// are contiguous in the segment. A segmented max by shuffles gives each
// lane the candidate of its group so far (the open group of the last
// window folded in); a group ends at a lane whose successor has another
// block. A step is one ballot over the group ends past the last insert:
// every entry up to the first end whose candidate beats the row's minimum
// keeps iff value >= minimum (the row as it stood before its group), and
// that candidate is inserted. The window's last group stays open. tl: the
// block of the row's last insert.
template <typename Row>
__device__ __forceinline__ void topn_block_window(
    Row& row, TopnGroup& g, uint2 e, int n, int w, int lane, int shard_len,
    int block, unsigned& tl, uint8_t* __restrict__ keep) {
  const float v = __uint_as_float(e.x);
  const unsigned blk = lane < n
                           ? (e.y % static_cast<unsigned>(shard_len)) /
                                 static_cast<unsigned>(block)
                           : 0xFFFFFFFFu;
  if (__shfl_sync(ROWPAR_FULL, blk, 0) != g.blk)
    topn_close(row, g, w, lane, tl);
  unsigned o = lane < n ? topn_cand_ord(cheetah_ftz(v)) : 0u;
  if (g.open && blk == g.blk) o = max(o, g.ord);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(ROWPAR_FULL, o, off);
    const unsigned b = __shfl_up_sync(ROWPAR_FULL, blk, off);
    if (lane >= off && b == blk) o = max(o, y);
  }
  const unsigned next = __shfl_down_sync(ROWPAR_FULL, blk, 1);
  const bool end = lane < n - 1 && next != blk;
  const float c = cheetah_unordered(o);
  bool kp = false;
  for (int done = 0;;) {
    const unsigned ins =
        __ballot_sync(ROWPAR_FULL, end && lane >= done && c > row.rmin);
    const int last = ins ? __ffs(ins) - 1 : n - 1;
    if (lane >= done && lane <= last) kp = v >= row.rmin;
    if (!ins) break;
    row.insert(__shfl_sync(ROWPAR_FULL, c, last), w, lane);
    tl = __shfl_sync(ROWPAR_FULL, blk, last);
    done = last + 1;
  }
  if (lane < n) keep[e.y] = kp;
  g.blk = __shfl_sync(ROWPAR_FULL, blk, n - 1);
  g.ord = __shfl_sync(ROWPAR_FULL, o, n - 1);
  g.open = true;
}

// One warp a segment g = lane * d + row over its entries [starts[g],
// starts[g + 1]) of the partitioned stream (value bits, index), loaded
// through the cp.async ring of rowpar.cuh, the row in registers. kBlock:
// block semantics (topn_block_window), else one entry at a time
// (topn_window). tinf (the kernels' family, else null): the block of each
// segment's last insert, for topn_onehot_fixup.
template <bool kBlock>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    topn_walk(const uint2* __restrict__ part, const int* __restrict__ starts,
              uint8_t* __restrict__ keep, float* __restrict__ states,
              long long nseg, int w, int shard_len, int block,
              unsigned* __restrict__ tinf, int resume) {
  __shared__ uint2 ring[ROWPAR_WARPS][ROWPAR_STAGES][32];
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= nseg) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lo = starts[g];
  const int hi = starts[g + 1];
  const int chunks = (hi - lo + 31) >> 5;
  auto issue = [&](int c) {
    const int j = lo + (c << 5) + lane;
    const bool in = c < chunks && j < hi;
    rowpar_cp<8>(&ring[warp][c % ROWPAR_STAGES][lane], part + (in ? j : 0),
                 in);
    rowpar_commit();
  };
  for (int c = 0; c < ROWPAR_STAGES - 1; ++c) issue(c);
  TopnRegRow row;
  if (resume) {  // the carried row, read before this warp writes it back
    row.r = lane < w ? states[g * w + lane] : cheetah_neg_value();
    row.rmin = __shfl_sync(ROWPAR_FULL, row.r, w - 1);
  }
  TopnGroup grp{false, 0xFFFFFFFFu, 0u};
  unsigned tl = 0xFFFFFFFFu;
  for (int c = 0; c < chunks; ++c) {
    __syncwarp();  // every lane is done with the slot this issue refills
    issue(c + ROWPAR_STAGES - 1);
    rowpar_wait();
    __syncwarp();  // every lane's copy of chunk c is visible to the warp
    const uint2 e = ring[warp][c % ROWPAR_STAGES][lane];
    const int n = min(32, hi - lo - (c << 5));
    if constexpr (kBlock)
      topn_block_window(row, grp, e, n, w, lane, shard_len, block, tl, keep);
    else
      topn_window(row, e, n, w, lane, shard_len, tl, keep);
  }
  rowpar_wait_all();
  topn_close(row, grp, w, lane, tl);
  if (lane < w) states[g * w + lane] = row.r;
  if (tinf && lane == 0) tinf[g] = tl;
}

// The walk for rows wider than a warp's registers (w > 32): one warp a
// segment as above, the row in shared memory, its entries loaded 32 at a
// time (one a lane).
template <bool kBlock>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    topn_walk_wide(const uint2* __restrict__ part,
                   const int* __restrict__ starts, uint8_t* __restrict__ keep,
                   float* __restrict__ states, long long nseg, int w,
                   int shard_len, int block, unsigned* __restrict__ tinf,
                   int resume) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * warps + warp;
  if (g >= nseg) return;  // whole warps
  TopnSmemRow row{
      reinterpret_cast<float*>(smem) + static_cast<size_t>(warp) * w,
      cheetah_neg_value()};
  for (int i = lane; i < w; i += 32)
    row.s[i] = resume ? states[g * w + i] : cheetah_neg_value();
  __syncwarp();
  row.rmin = row.s[w - 1];
  TopnGroup grp{false, 0xFFFFFFFFu, 0u};
  unsigned tl = 0xFFFFFFFFu;
  const int lo = starts[g];
  const int hi = starts[g + 1];
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int n = min(32, hi - c0);
    const uint2 e = lane < n ? part[c0 + lane] : make_uint2(0u, 0u);
    if constexpr (kBlock)
      topn_block_window(row, grp, e, n, w, lane, shard_len, block, tl, keep);
    else
      topn_window(row, e, n, w, lane, shard_len, tl, keep);
  }
  topn_close(row, grp, w, lane, tl);
  const long long o = g * w;
  for (int i = lane; i < w; i += 32) states[o + i] = row.s[i];
  if (tinf && lane == 0) tinf[g] = tl;
}

// The kernels' family of pass 1 (the Pallas one-hot read of the row
// minimum, kernels/ref.py onehot_keep), after any form of pass 1 has written
// the direct read's keep, the matrices and tinf, the block of each row's
// last insert. A row whose final minimum is +inf became so at its last
// insert; with t1 <= t2 the two earliest such blocks of a lane and r1 the
// row of t1, an entry of block b keeps as written up to t1, only in row r1
// up to t2, and never after. Grid (gx, lanes): each CTA reduces its lane's
// d minima to (t1, r1, t2), packed as (t << 32 | r) minima, and returns
// when no minimum is +inf (the main path: one read of d minima a CTA); else
// it rewrites its share of the lane's entries after block t1.
#define FIXUP_THREADS 256

struct FixupMin {
  unsigned long long first;  // (t1 << 32) | r1
  unsigned second;           // t2
};

__device__ __forceinline__ FixupMin fixup_fold(FixupMin a, FixupMin b) {
  FixupMin o;
  const bool lt = a.first < b.first;
  o.first = lt ? a.first : b.first;
  const unsigned other =
      static_cast<unsigned>((lt ? b.first : a.first) >> 32);
  o.second = min(min(a.second, b.second), other);
  return o;
}

__global__ void __launch_bounds__(FIXUP_THREADS)
    topn_onehot_fixup_kernel(uint8_t* __restrict__ keep,
                             const float* __restrict__ states,
                             const unsigned* __restrict__ tinf, int shard_len,
                             int d, int w, int block, uint32_t seed) {
  __shared__ FixupMin part[FIXUP_THREADS / 32];
  const int lane = blockIdx.y;
  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(lane) * d;
  FixupMin acc{~0ull, 0xFFFFFFFFu};
  for (int r = t; r < d; r += FIXUP_THREADS) {
    if (__float_as_uint(states[(row0 + r) * w + w - 1]) != 0x7F800000u)
      continue;
    const FixupMin e{(static_cast<unsigned long long>(tinf[row0 + r]) << 32) |
                         static_cast<unsigned>(r),
                     0xFFFFFFFFu};
    acc = fixup_fold(acc, e);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    FixupMin o;
    o.first = __shfl_down_sync(0xFFFFFFFFu, acc.first, off);
    o.second = __shfl_down_sync(0xFFFFFFFFu, acc.second, off);
    acc = fixup_fold(acc, o);
  }
  if ((t & 31) == 0) part[t >> 5] = acc;
  __syncthreads();
  acc = part[0];
  for (int i = 1; i < FIXUP_THREADS / 32; ++i) acc = fixup_fold(acc, part[i]);
  if (acc.first == ~0ull) return;  // no row minimum is +inf
  const unsigned t1 = static_cast<unsigned>(acc.first >> 32);
  const int r1 = static_cast<int>(acc.first & 0xFFFFFFFFu);
  const unsigned t2 = acc.second;
  const long long from = (static_cast<long long>(t1) + 1) * block;
  uint8_t* k = keep + static_cast<long long>(lane) * shard_len;
  const long long stride = static_cast<long long>(gridDim.x) * FIXUP_THREADS;
  for (long long j = from + static_cast<long long>(blockIdx.x) * FIXUP_THREADS
                     + t;
       j < shard_len; j += stride) {
    const unsigned blk = static_cast<unsigned>(j / block);
    if (blk > t2)
      k[j] = 0;
    else if (k[j] &&
             cheetah_hash_mod(static_cast<uint32_t>(j), d, seed) != r1)
      k[j] = 0;
  }
}

struct TopnWork {
  RowparPlan plan;
  size_t partition, part, total;
};

TopnWork topn_work(int shards, int shard_len, int d) {
  TopnWork k;
  k.plan = rowpar_plan(shards, shard_len, d);
  k.partition = rowpar_partition_bytes(k.plan);
  k.part = rowpar_align(static_cast<long long>(shards) * shard_len * sizeof(uint2));
  k.total = k.partition + k.part;  // partition scratch; the partitioned stream
  return k;
}

// The retired apply (see the header).
__global__ void topn_apply_grid_kernel(const float* __restrict__ x,
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

#define APPLY_THREADS 256
#define APPLY_UNROLL 4  // shards a thread has in flight

// The read of a row minimum v: the kernels' family (kfam) reads NaN when
// another row's minimum is not finite (nf counts them) or v is NaN.
__device__ __forceinline__ float apply_read(float v, int nf, int kfam) {
  const bool own = !isfinite(v);
  return kfam && (nf > static_cast<int>(own) || v != v)
             ? __int_as_float(0x7FC00000)
             : v;
}

// x >= r with f32 subnormals flushed, as XLA compares: 1 or 0.
__device__ __forceinline__ unsigned apply_ge(float x, float r) {
  unsigned k;
  asm("{\n\t.reg .pred p;\n\tsetp.ge.ftz.f32 p, %1, %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(k)
      : "f"(x), "f"(r));
  return k;
}

// Four keeps as one word, entry 0 in the low byte.
__device__ __forceinline__ unsigned apply_quad(float4 v, float r0, float r1,
                                               float r2, float r3) {
  return apply_ge(v.x, r0) | apply_ge(v.y, r1) << 8 | apply_ge(v.z, r2) << 16 |
         apply_ge(v.w, r3) << 24;
}

// Of a thread's 7 reads r[0..6] (entries 4q .. 4q + 6), read t of a shard
// whose quads start h entries in: r[h + t], by selects.
__device__ __forceinline__ float apply_pick(const float (&r)[7], int i) {
  float o = r[0];
#pragma unroll
  for (int k = 1; k < 7; ++k) o = i == k ? r[k] : o;
  return o;
}

// Stages the column in shared memory (kernels' family: with its count of
// non-finite minima), or reads the count a pre-pass left (global reads).
__device__ __forceinline__ int apply_stage(const float* __restrict__ col,
                                           long long rstride, int d,
                                           float* s, int* cnt, int staged,
                                           const int* __restrict__ nf_global,
                                           int kfam) {
  if (!staged) return kfam ? *nf_global : 0;
  if (threadIdx.x == 0) *cnt = 0;
  __syncthreads();
  int c = 0;
  for (int r = threadIdx.x; r < d; r += blockDim.x) {
    const float v = col[r * rstride];
    s[r] = v;
    c += !isfinite(v);
  }
  if (c) atomicAdd(cnt, c);
  __syncthreads();
  return *cnt;
}

__device__ __forceinline__ float apply_min(const float* __restrict__ col,
                                           long long rstride, const float* s,
                                           int staged, int row) {
  return staged ? s[row] : col[row * rstride];
}

// The apply on aligned shards (x on 16 bytes, L % 4 == 0): thread q of
// blockIdx.x owns entries 4q .. 4q + 3 of every shard of its group.
__global__ void __launch_bounds__(APPLY_THREADS, 4)
    topn_apply_aligned(const float* __restrict__ x,
                       const float* __restrict__ col, long long rstride,
                       uint8_t* __restrict__ keep, int shards, int L, int d,
                       uint32_t seed, int kfam, int per_group, int staged,
                       const int* __restrict__ nf_global, uint32_t off) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  const int nf = apply_stage(col, rstride, d, s, reinterpret_cast<int*>(s + d),
                             staged, nf_global, kfam);
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (L >> 2)) return;
  const int j = q << 2;
  float r[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    r[t] = apply_read(
        apply_min(col, rstride, s, staged,
                  cheetah_hash_mod(static_cast<uint32_t>(j + t) + off, d,
                                   seed)),
        nf, kfam);
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(shards, s0 + per_group);
  for (int sh = s0; sh < s1; sh += APPLY_UNROLL) {
    float4 v[APPLY_UNROLL];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u)
      if (sh + u < s1)
        v[u] = __ldcs(reinterpret_cast<const float4*>(
            x + static_cast<long long>(sh + u) * L + j));
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u)
      if (sh + u < s1)
        __stcs(reinterpret_cast<unsigned*>(
                   keep + static_cast<long long>(sh + u) * L + j),
               apply_quad(v[u], r[0], r[1], r[2], r[3]));
  }
}

// The apply on shards at any 4-byte offset: a shard's quads sit on its
// 16-byte grid, h = (4 - (xoff + s * L) % 4) % 4 entries in (xoff: x's
// offset in floats mod 4), so thread q takes entries h + 4q .. h + 4q + 3
// of it while they are whole, and holds the reads of entries 4q .. 4q + 6;
// thread 0 takes the head (entries below h) and the thread past the last
// whole quad the tail, both by single loads and stores.
__global__ void __launch_bounds__(APPLY_THREADS, 4)
    topn_apply_shifted(const float* __restrict__ x,
                       const float* __restrict__ col, long long rstride,
                       uint8_t* __restrict__ keep, int shards, int L, int d,
                       uint32_t seed, int kfam, int per_group, int staged,
                       const int* __restrict__ nf_global, uint32_t off) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s = reinterpret_cast<float*>(smem);
  const int nf = apply_stage(col, rstride, d, s, reinterpret_cast<int*>(s + d),
                             staged, nf_global, kfam);
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q > (L >> 2)) return;
  const int j = q << 2;
  float r[7];
#pragma unroll
  for (int t = 0; t < 7; ++t)
    r[t] = j + t < L
               ? apply_read(apply_min(col, rstride, s, staged,
                                      cheetah_hash_mod(
                                          static_cast<uint32_t>(j + t) + off,
                                          d, seed)),
                            nf, kfam)
               : 0.0f;
  const int xoff = static_cast<int>((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(shards, s0 + per_group);
  for (int sh = s0; sh < s1; ++sh) {
    const long long base = static_cast<long long>(sh) * L;
    const int h = (4 - static_cast<int>((xoff + base) & 3)) & 3;
    const int nq = (L - h) >> 2;  // whole quads of the shard
    if (q < nq) {
      const int e = h + j;
      const float4 v =
          __ldcs(reinterpret_cast<const float4*>(x + base + e));
      __stcs(reinterpret_cast<unsigned*>(keep + base + e),
             apply_quad(v, apply_pick(r, h), apply_pick(r, h + 1),
                        apply_pick(r, h + 2), apply_pick(r, h + 3)));
    }
    if (q == nq)  // the tail: entries h + 4 nq .. L - 1
      for (int e = h + j; e < L; ++e)
        keep[base + e] = apply_ge(x[base + e], apply_pick(r, e - j));
    if (q == 0)  // the head: entries 0 .. h - 1
      for (int e = 0; e < min(h, L); ++e)
        keep[base + e] = apply_ge(x[base + e], apply_pick(r, e));
  }
}

// The kernels' family without staging (a column above the shared memory):
// the count of non-finite minima, into work[0] (zeroed first).
__global__ void topn_apply_count(const float* __restrict__ col,
                                 long long rstride, int d,
                                 int* __restrict__ work) {
  int c = 0;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < d;
       r += gridDim.x * blockDim.x)
    c += !isfinite(col[r * rstride]);
  if (c) atomicAdd(work, c);
}

// Dynamic shared memory of the apply: the staged column and its count, or
// 0 when it does not fit (the minima are then read from global memory).
size_t topn_apply_smem(int d) {
  const size_t b = static_cast<size_t>(d) * sizeof(float) + 16;
  return b <= CHEETAH_MAX_SMEM ? b : 0;
}

// The row-parallel walk (any B >= 1): the partition by (lane, row), then
// one warp a segment. work holds topn_work(...).total bytes.
cudaError_t topn_walk_launch(const float* x, uint8_t* keep, float* states,
                             int shards, int shard_len, int d, int w,
                             int block, uint32_t seed, unsigned char* work,
                             unsigned* tinf, uint32_t idx_off, int resume,
                             cudaStream_t stream) {
  if (w < 1 || block < 1 ||
      (w > 32 && rowpar_wide_warps(static_cast<size_t>(w) * 4) == 0))
    return cudaErrorInvalidValue;
  TopnWork k = topn_work(shards, shard_len, d);
  k.plan.idx_off = idx_off;
  const long long nseg = static_cast<long long>(shards) * d;
  uint2* part = reinterpret_cast<uint2*>(work + k.partition);
  int* starts = nullptr;
  cudaError_t err = rowpar_partition(reinterpret_cast<const uint32_t*>(x),
                                     nullptr, nullptr, k.plan, seed, part,
                                     work, &starts, stream, true);
  if (err != cudaSuccess) return err;
  if (w <= 32) {
    const unsigned blocks = static_cast<unsigned>(
        (nseg * 32 + ROWPAR_THREADS - 1) / ROWPAR_THREADS);
    if (block > 1)
      topn_walk<true><<<blocks, ROWPAR_THREADS, 0, stream>>>(
          part, starts, keep, states, nseg, w, shard_len, block, tinf,
          resume);
    else
      topn_walk<false><<<blocks, ROWPAR_THREADS, 0, stream>>>(
          part, starts, keep, states, nseg, w, shard_len, block, tinf,
          resume);
    return cudaGetLastError();
  }
  const int warps = rowpar_wide_warps(static_cast<size_t>(w) * 4);
  const size_t smem = static_cast<size_t>(warps) * w * sizeof(float);
  const unsigned blocks = static_cast<unsigned>((nseg + warps - 1) / warps);
  const void* fn = block > 1
                       ? reinterpret_cast<const void*>(topn_walk_wide<true>)
                       : reinterpret_cast<const void*>(topn_walk_wide<false>);
  err = cheetah_launch_prep(fn, smem);
  if (err != cudaSuccess) return err;
  if (block > 1)
    topn_walk_wide<true><<<blocks, warps * 32, smem, stream>>>(
        part, starts, keep, states, nseg, w, shard_len, block, tinf, resume);
  else
    topn_walk_wide<false><<<blocks, warps * 32, smem, stream>>>(
        part, starts, keep, states, nseg, w, shard_len, block, tinf, resume);
  return cudaGetLastError();
}

// The batched walk (topn_pass1_batch): a wave of queries over one stream,
// each with its own d, w and seed, partitioned on the query axis
// (rowpar_partition_q, by index); one warp a (query, lane, row) segment
// takes the B = 1 steps of topn_walk with its query's w, and writes its row
// into the padded state [Q][S][dcap][wcap] (slots past w stay NEG; rows a
// query does not have are filled by the wrapper). keep is [Q][m].
__global__ void __launch_bounds__(ROWPAR_THREADS)
    topn_walk_q(const uint2* __restrict__ part, const int* __restrict__ starts,
                uint8_t* __restrict__ keep, float* __restrict__ states,
                RowparQ p) {
  __shared__ uint2 ring[ROWPAR_WARPS][ROWPAR_STAGES][32];
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= p.nseg) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int q, sl, row_id;
  rowpar_segment_q(p, g, &q, &sl, &row_id);
  const int w = p.w[q];
  uint8_t* kq = keep + static_cast<long long>(q) * p.shards * p.shard_len;
  const int lo = starts[g];
  const int hi = starts[g + 1];
  const int chunks = (hi - lo + 31) >> 5;
  auto issue = [&](int c) {
    const int j = lo + (c << 5) + lane;
    const bool in = c < chunks && j < hi;
    rowpar_cp<8>(&ring[warp][c % ROWPAR_STAGES][lane], part + (in ? j : 0),
                 in);
    rowpar_commit();
  };
  for (int c = 0; c < ROWPAR_STAGES - 1; ++c) issue(c);
  TopnRegRow row;
  unsigned tl = 0u;
  for (int c = 0; c < chunks; ++c) {
    __syncwarp();  // every lane is done with the slot this issue refills
    issue(c + ROWPAR_STAGES - 1);
    rowpar_wait();
    __syncwarp();  // every lane's copy of chunk c is visible to the warp
    const uint2 e = ring[warp][c % ROWPAR_STAGES][lane];
    const int n = min(32, hi - lo - (c << 5));
    topn_window(row, e, n, w, lane, p.shard_len, tl, kq);
  }
  rowpar_wait_all();
  if (lane < p.wcap) states[rowpar_slot_q(p, q, sl, row_id) + lane] = row.r;
}

// The block kernel's layout: the matrix, the candidates, the ring.
StagedPlan topn_block_plan(int d, int w, int block) {
  return staged_plan(static_cast<size_t>(d) * w * sizeof(float) +
                         static_cast<size_t>(d) * sizeof(unsigned),
                     block);
}

}  // namespace

// Shared memory of the block kernel (B > 1), its ring included; the walk
// needs none of it.
extern "C" size_t topn_pass1_smem(int d, int w, int block) {
  return topn_block_plan(d, w, block).total;
}

// Workspace of the walk (topn_pass1 at B = 1, topn_pass1_block_walk); the
// block kernel takes none.
extern "C" size_t topn_pass1_workspace(int shards, int shard_len, int d) {
  return topn_work(shards, shard_len, d).total;
}

// B = 1: the row-parallel walk; B > 1: the one-CTA-a-lane block kernel.
// tinf (the kernels' family, else null): uint32 [shards * d], the block of
// each row's last insert, for topn_onehot_fixup (the block kernel writes
// only the rows whose minimum became +inf). idx_off and resume (B = 1
// only, the streaming fold): the rows hash the shard-local index plus
// idx_off, and each (lane, row) starts from the row ``states`` holds.
extern "C" int topn_pass1(const float* x, uint8_t* keep, float* states,
                          int shards, int shard_len, int d, int w, int block,
                          uint32_t seed, unsigned char* work, unsigned* tinf,
                          uint32_t idx_off, int resume, cudaStream_t stream) {
  if (block > 1) {
    if (idx_off || resume) return cudaErrorInvalidValue;
    if (block > 1024 || shard_len % block) return cudaErrorInvalidValue;
    const StagedPlan p = topn_block_plan(d, w, block);
    const void* fn = tinf ? reinterpret_cast<const void*>(topn_pass1_block<true>)
                          : reinterpret_cast<const void*>(topn_pass1_block<false>);
    cudaError_t err = cheetah_launch_prep(fn, p.total);
    if (err != cudaSuccess) return err;
    if (tinf)
      topn_pass1_block<true><<<shards, block, p.total, stream>>>(
          x, keep, states, shard_len, d, w, seed, p.cps, p.stages,
          static_cast<int>(p.ring), static_cast<int>(p.slot), tinf);
    else
      topn_pass1_block<false><<<shards, block, p.total, stream>>>(
          x, keep, states, shard_len, d, w, seed, p.cps, p.stages,
          static_cast<int>(p.ring), static_cast<int>(p.slot), nullptr);
    return cudaGetLastError();
  }
  return topn_walk_launch(x, keep, states, shards, shard_len, d, w, 1, seed,
                          work, tinf, idx_off, resume, stream);
}

// The retired block kernel (B > 1), for holding the staged block kernel
// against it; launched by no entry point of the package.
extern "C" int topn_pass1_block_unstaged(const float* x, uint8_t* keep,
                                         float* states, int shards,
                                         int shard_len, int d, int w,
                                         int block, uint32_t seed,
                                         cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * w * sizeof(float) +
                      static_cast<size_t>(d) * sizeof(unsigned);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(topn_pass1_block_unstaged_kernel), smem);
  if (err != cudaSuccess) return err;
  topn_pass1_block_unstaged_kernel<<<shards, block, smem, stream>>>(
      x, keep, states, shard_len, d, w, seed);
  return cudaGetLastError();
}

// The row-parallel block walk (block semantics, B >= 1); work holds
// topn_pass1_workspace bytes; tinf as topn_pass1's.
extern "C" int topn_pass1_block_walk(const float* x, uint8_t* keep,
                                     float* states, int shards, int shard_len,
                                     int d, int w, int block, uint32_t seed,
                                     unsigned char* work, unsigned* tinf,
                                     cudaStream_t stream) {
  return topn_walk_launch(x, keep, states, shards, shard_len, d, w, block,
                          seed, work, tinf, 0u, 0, stream);
}

// The kernels' family of pass 1 (kernels/ref.py, onehot_keep): grid (gx,
// shards), FIXUP_THREADS threads. keep holds the direct read's keep.
extern "C" int topn_onehot_fixup(uint8_t* keep, const float* states,
                                 const unsigned* tinf, int shards,
                                 int shard_len, int d, int w, int block,
                                 uint32_t seed, int gx, cudaStream_t stream) {
  if (shards < 1 || shard_len < 1 || d < 1 || w < 1 || block < 1 || gx < 1)
    return cudaErrorInvalidValue;
  topn_onehot_fixup_kernel<<<dim3(gx, shards), FIXUP_THREADS, 0, stream>>>(
      keep, states, tinf, shard_len, d, w, block, seed);
  return cudaGetLastError();
}

// The retired one-thread walk, for holding the row-parallel walk against it;
// launched by no entry point of the package.
extern "C" int topn_pass1_serial(const float* x, uint8_t* keep, float* states,
                                 int shards, int shard_len, int d, int w,
                                 uint32_t seed, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * w * sizeof(float) +
                      CHEETAH_STAGE * (sizeof(float) + sizeof(int) + 1);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(topn_pass1_serial_kernel), smem);
  if (err != cudaSuccess) return err;
  topn_pass1_serial_kernel<<<shards, CHEETAH_STAGE, smem, stream>>>(
      x, keep, states, shard_len, d, w, seed);
  return cudaGetLastError();
}

// The apply's grid on the current device: out = (CTAs over a shard's quads,
// groups of shards, dynamic shared memory). One wave: as many CTAs as the
// SMs hold at once, the shards split into as many groups as that allows.
extern "C" int topn_apply_plan(int shards, int shard_len, int d, int aligned,
                               int* out) {
  const size_t smem = topn_apply_smem(d);
  const void* fn = aligned ? reinterpret_cast<const void*>(topn_apply_aligned)
                           : reinterpret_cast<const void*>(topn_apply_shifted);
  cudaError_t err = cheetah_launch_prep(fn, smem);
  if (err != cudaSuccess) return err;
  int occ = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, APPLY_THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long quads = (shard_len >> 2) + (aligned ? 0 : 1);
  const long long gx = (quads + APPLY_THREADS - 1) / APPLY_THREADS;
  const long long fit = static_cast<long long>(sms) * std::max(occ, 1) / gx;
  out[0] = static_cast<int>(gx);
  out[1] = static_cast<int>(std::max(
      1ll, std::min(static_cast<long long>(std::min(shards, 65535)), fit)));
  out[2] = static_cast<int>(smem);
  return cudaSuccess;
}

// work: one int, for the kernels' family when the column is not staged
// (smem == 0). off: added to the shard-local index before it is hashed
// (mod 2^32), as the engine's apply of a streamed micro-batch hashes it.
extern "C" int topn_apply(const float* x, const float* col, long long rstride,
                          uint8_t* keep, int shards, int shard_len, int d,
                          uint32_t seed, int kfam, int aligned, int gx,
                          int groups, int smem, int* work, uint32_t off,
                          cudaStream_t stream) {
  if (shards < 1 || shard_len < 1 || d < 1 || gx < 1 || groups < 1)
    return cudaErrorInvalidValue;
  const int staged = smem > 0;
  if (!staged && kfam) {
    const cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int), stream);
    if (err != cudaSuccess) return err;
    topn_apply_count<<<std::min(d / 256 + 1, 64), 256, 0, stream>>>(
        col, rstride, d, work);
  }
  // The shared-memory limit is a function's, set to the last value asked:
  // another shape's plan may have lowered it since this shape's was made.
  cudaError_t err = cheetah_launch_prep(
      aligned ? reinterpret_cast<const void*>(topn_apply_aligned)
              : reinterpret_cast<const void*>(topn_apply_shifted),
      static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  const int per_group = (shards + groups - 1) / groups;
  const dim3 grid(gx, (shards + per_group - 1) / per_group);
  if (aligned)
    topn_apply_aligned<<<grid, APPLY_THREADS, smem, stream>>>(
        x, col, rstride, keep, shards, shard_len, d, seed, kfam, per_group,
        staged, work, off);
  else
    topn_apply_shifted<<<grid, APPLY_THREADS, smem, stream>>>(
        x, col, rstride, keep, shards, shard_len, d, seed, kfam, per_group,
        staged, work, off);
  return cudaGetLastError();
}

// The retired apply, for holding the apply against it; launched by no entry
// point of the package. rowmin: the column as a contiguous [d].
extern "C" int topn_apply_grid(const float* x, const float* rowmin,
                               uint8_t* keep, long long m, int shard_len,
                               int d, uint32_t seed, int grid,
                               cudaStream_t stream) {
  const int staged = static_cast<size_t>(d) * sizeof(float) <= 48 * 1024;
  const size_t smem = staged ? static_cast<size_t>(d) * sizeof(float) : 0;
  topn_apply_grid_kernel<<<grid, 256, smem, stream>>>(
      x, rowmin, keep, m, shard_len, d, seed, staged);
  return cudaGetLastError();
}

// The batched walk's workspace: the query-axis partition's scratch and
// the nq * m partitioned entries. d: the nq queries' rows.
extern "C" size_t rowpar_batch_workspace(int nq, int shards, int shard_len,
                                         const int* d, int entry_bytes) {
  if (nq < 1 || nq > ROWPAR_MAX_Q) return 0;
  uint32_t seeds[ROWPAR_MAX_Q] = {};
  const RowparQ p =
      rowpar_plan_q(nq, shards, shard_len, d, nullptr, seeds, 0, 0);
  return rowpar_partition_bytes_q(p) +
         rowpar_align(static_cast<size_t>(nq) * shards * shard_len * entry_bytes);
}

// TOP-N pass 1 of a wave of nq <= ROWPAR_MAX_Q queries (B = 1, the engine's
// family): keep [nq][m], states [nq][shards][dcap][wcap] (the wrapper fills
// it with NEG first). d, w, seed: host arrays of nq, w <= wcap <= 32.
extern "C" int topn_pass1_batch(const float* x, uint8_t* keep, float* states,
                                int nq, int shards, int shard_len,
                                const int* d, const int* w,
                                const uint32_t* seed, int dcap, int wcap,
                                unsigned char* work, cudaStream_t stream) {
  if (nq < 1 || nq > ROWPAR_MAX_Q || wcap < 1 || wcap > 32)
    return cudaErrorInvalidValue;
  for (int q = 0; q < nq; ++q)
    if (w[q] < 1 || w[q] > wcap || d[q] < 1 || d[q] > dcap)
      return cudaErrorInvalidValue;
  const RowparQ p =
      rowpar_plan_q(nq, shards, shard_len, d, w, seed, dcap, wcap);
  uint2* part = reinterpret_cast<uint2*>(work + rowpar_partition_bytes_q(p));
  int* starts = nullptr;
  cudaError_t err = rowpar_partition_q(reinterpret_cast<const uint32_t*>(x),
                                       nullptr, nullptr, p, part, work,
                                       &starts, stream, true);
  if (err != cudaSuccess) return err;
  topn_walk_q<<<static_cast<unsigned>((p.nseg * 32 + ROWPAR_THREADS - 1) /
                                      ROWPAR_THREADS),
                ROWPAR_THREADS, 0, stream>>>(part, starts, keep, states, p);
  return cudaGetLastError();
}
