// DISTINCT pruning (paper Ex. 2) on Hopper: pass 1 (FIFO, and LRU at B = 1)
// and pass 2.
//
// distinct_pass1 replaces two pallas_calls of the JAX package:
//   distinct_prune_kernel         src/repro/kernels/distinct_prune.py:67  (S = 1)
//   distinct_shard_states_kernel  src/repro/kernels/parallel.py:209       (S shards)
// and, at B = 1 with lru = 1, the lax.scan of core.distinct.distinct_prune
// with policy "lru" (src/repro/core/distinct.py:47-58), which has no Pallas
// kernel.
//
// B = 1 (the engine's per-entry semantics, FIFO or LRU): the row-parallel
// walk. An entry reads and writes only the row its key hashes to, so a lane
// is d independent chains. After the stable partition by (lane, row) of
// rowpar.cuh:
//   - distinct_mark: an entry whose segment predecessor has the same key,
//     and which can hit, hits its own key and changes nothing (FIFO: the key
//     is cached; LRU: it is at slot 0), so it is a no-op with keep = 0; the
//     others are flagged, and an exclusive scan of the flags places them;
//   - distinct_compact: the flagged entries, in order, with the key the
//     slot stores and the index (sign bit: the entry cannot hit);
//   - distinct_walk: one warp a segment, the row's w slots in registers of
//     every lane (templated on a bound W >= w, valid flags as a bit mask),
//     its entries loaded through a cp.async ring seven chunks of 32 ahead
//     and read by every lane from shared memory, a whole chunk's steps
//     unrolled. FIFO: a miss inserts at head[row], which advances mod w. LRU: a
//     hit moves its slot to the front (slots 1..hitpos take 0..hitpos-1), a
//     miss inserts at the front and the last slot falls out; head stays 0.
//     keep = miss; each row's final slots, flags and head are written, the
//     empty ones included. Rows of w > 32 slots take distinct_walk_wide:
//     the same steps on a row in shared memory, probed lane-strided.
// Keys: a uint32 stream compares by value. A float32 stream (fmode = 1) is
// the JAX package's f32 column: the row is hashed from the value's bits,
// the slot stores the value converted toward zero with saturation (NaN to
// 0, as XLA converts f32 to uint32) and an entry hits only a slot equal to
// that key when the key converts back to the value (the reference compares
// slot and value in f32).
//
// B > 1, block semantics as in src/repro/kernels/ref.py: an entry is kept
// when it misses its row as the row stood before its block (of B entries
// of the lane), and of each (row, block) only the first miss inserts, at
// head[row]. An entry still reads and writes only its own row, so the
// dependent chain is per (lane, row) and per block, not per block of the
// lane. Two forms, picked by the shape in kernels/parallel.py:
//   - distinct_pass1_block_walk, the row-parallel block walk: the same
//     partition as at B = 1; distinct_mark drops an entry whose segment
//     predecessor has the same key, the same hit rule and the same block
//     (it misses or hits with its predecessor and is never its group's
//     first miss; a repeat from an earlier block is kept in the walk,
//     since that block may have inserted over the slot it would hit);
//     distinct_compact writes the others as (key, block id); then
//     distinct_block_walk takes one warp a segment through the cp.async
//     ring, 32 entries a window from the first unresolved one. Every
//     entry of the window is probed against the row as it stands, except
//     that an entry of the group that inserted last sees the slot that
//     insert overwrote as it was. The first miss of a later group inserts
//     at head, and every entry up to the end of that group in the window
//     is resolved (keep = miss); a window with no such miss resolves all
//     of its entries. distinct_fill gives each dropped repeat the keep of
//     the entry it repeats. Rows of w > 32 slots take
//     distinct_block_walk_wide, the row in shared memory.
//   - distinct_pass1_block (one CTA a lane, its d x w cache in shared
//     memory; a chunk's hits read the pre-chunk cache, and the first miss
//     of each row, a shared atomicMin of its chunk position, inserts). It
//     is the faster form when the lanes fill the card: its chain is
//     shard_len / B steps a lane. The stream comes through the cp.async
//     ring of staged.cuh, stages ahead of the chain and fetched two chunks
//     ahead; the next chunk's key, hit rule and row are computed while the
//     step's probe is in flight. At d = 4096, w = 4 the cache takes 80 KB
//     and the ring 64 KB, so the launch opts into dynamic shared memory.
//     distinct_pass1_block_unstaged is the block kernel it replaced (each
//     step loaded its entry from device memory, and probed w slots and w
//     valid flags one by one); no entry point of the package launches it,
//     and chip_smoke.py holds the staged kernel against it.
//
// distinct_pass1_batch carries a wave of queries (core.batched, B = 1):
// the query-axis partition of rowpar.cuh, the repeats dropped and the rest
// compacted as for one query (distinct_mark_q, distinct_compact), then
// distinct_walk_q, one warp a (query, lane, row) segment taking
// distinct_walk's steps with its query's w, into the batch's padded state.
//
// A resumed walk (B = 1, resume = 1: the streaming fold, core.streaming)
// starts each row from the slots, valid flags and head the outputs already
// hold, which its warp reads first and writes back at its end (in place);
// distinct_mark's rule stays exact, since a dropped repeat follows an
// entry of this call whose key the row then holds (FIFO: cached; LRU: in
// front). LRU leaves the head as it was.
//
// distinct_pass1_serial is the kernel the B = 1 walk replaced (one thread of a
// CTA walks its lane's entries in order, the cache in shared memory). No
// entry point of the package launches it; chip_smoke.py holds the walk
// against it at full size.
//
// What bounds the walks: the longest segment's chain (at B = 1 its
// survivors of the collapse, one dependent step on registers each, at
// least a compare and select; at B > 1 its groups that insert, one window
// each), or the bytes of the partition; the block kernel: shard_len / B
// chunk steps of an atomicMin and two barriers.
//
// distinct_apply replaces distinct_apply_kernel (src/repro/kernels/parallel.py:267):
// an entry kept by pass 1 is dropped when a valid slot of its row in the
// merged union, in the columns [0, lane * w) of the lower-ranked shards,
// holds its key (and it can hit). That is one number per (row, key): the
// lowest shard whose valid slot of the row holds the key. So
// distinct_owner_build reduces each row of the [d][S*w] union, one CTA a
// row, to an open-addressed table of 2^tbits >= 2 * S * w packed
// (owner, key) slots (in shared memory, written out once; in place when
// it does not fit), and distinct_owner_apply gives each pass-1 survivor
// that can hit one lookup: dup = owner < lane. A thread takes 16
// consecutive entries (keep1 and keep as 16-byte words, the lane divided
// out once a run). At d = 4096, S * w = 512 the table holds 32 MB, inside
// the 50 MB L2. Bound: bytes (keep1, keep, the survivors' keys, the
// union). distinct_apply_scan is the kernel it replaced (each survivor
// scans the lower shards' columns of its row, up to S * w - w probes);
// no entry point of the package launches it, and chip_smoke.py holds the
// lookup against it at full size.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "rowpar.cuh"
#include "staged.cuh"

namespace {

// The key a slot stores for an entry of bits x, and whether the entry can
// hit a slot holding it (see the header).
__device__ __forceinline__ uint32_t distinct_key(uint32_t x, int fmode,
                                                 bool* hittable) {
  if (!fmode) {
    *hittable = true;
    return x;
  }
  const float f = __uint_as_float(x);
  const uint32_t k = __float2uint_rz(f);  // saturating, NaN to 0
  *hittable = __uint2float_rn(k) == cheetah_ftz(f);  // XLA flushes (A25)
  return k;
}

// The kernel the row-parallel walk replaced; kLru selects the policy.
template <bool kLru>
__global__ void distinct_serial_kernel(const uint32_t* __restrict__ x,
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

// The retired block kernel (see the header); blockDim.x == block.
__global__ void distinct_pass1_block_unstaged_kernel(
    const uint32_t* __restrict__ x, uint8_t* __restrict__ keep,
    uint32_t* __restrict__ slots_out, uint8_t* __restrict__ valid_out,
    int* __restrict__ head_out, int shard_len, int d, int w, int fmode,
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
    const uint32_t bits = x[i];
    bool can;
    const uint32_t v = distinct_key(bits, fmode, &can);
    const int r = cheetah_hash_mod(bits, d, seed);
    const int b = r * w;
    bool hit = false;
    for (int j = 0; j < w; ++j) hit |= valid[b + j] && slots[b + j] == v;
    hit &= can;
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

// The row state of the staged block kernel: its head, and whether it has
// filled (every slot valid; until then its valid slots are the first head).
#define DISTINCT_FULL (1 << 30)

// The block kernel (B > 1), one CTA a lane, blockDim.x == block: thread t
// takes entry t of every chunk of B entries. Its d x w slots are in shared
// memory beside an int a row, head | DISTINCT_FULL once the row has filled:
// a FIFO row fills in slot order, so its valid slots are a prefix, and a
// probe reads the slots (16 bytes at a time when w % 4 == 0) and that int
// instead of w valid flags. Its stream comes through the ring of
// staged.cuh, fetched two chunks ahead. A step (one chunk): the entry
// probes its row as it stood before the chunk (keep = miss, a byte stored
// straight to keep); a miss takes a shared atomicMin of t into first[row];
// the next chunk's key, hit rule and row (all of the entry alone) are
// computed while the probe is in flight; a barrier; the row's first miss
// inserts at head and re-arms first[row]; a barrier. A step's time is the
// instructions and shared-memory operations of its B entries on one SM.
__global__ void __launch_bounds__(1024)
    distinct_pass1_block(const uint32_t* __restrict__ x,
                         uint8_t* __restrict__ keep,
                         uint32_t* __restrict__ slots_out,
                         uint8_t* __restrict__ valid_out,
                         int* __restrict__ head_out, int shard_len, int d,
                         int w, int fmode, uint32_t seed, int cps, int stages,
                         int ring_off, int slot) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem);
  int* hf = reinterpret_cast<int*>(slots + d * w);  // head | DISTINCT_FULL
  int* first = hf + d;
  const int B = blockDim.x;
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * shard_len;
  const int nchunks = shard_len / B;
  StagedRing ring{x + base, reinterpret_cast<uint32_t*>(smem + ring_off), t,
                  B, cps, stages, nchunks, static_cast<size_t>(slot)};
  for (int i = t; i < d * w; i += B) slots[i] = 0u;
  for (int r = t; r < d; r += B) {
    hf[r] = 0;
    first[r] = B;
  }
  ring.start();
  __syncthreads();
  bool can;
  const uint32_t bits = ring.first();
  uint32_t v = distinct_key(bits, fmode, &can);
  int r = cheetah_hash_mod(bits, d, seed);
  uint32_t bits1 = nchunks > 1 ? ring.next() : 0u;
  __syncthreads();
  const bool quads = (w & 3) == 0;
  for (int c = 0; c < nchunks; ++c) {
    const int b = r * w;
    // the row's state and its slots, loaded together; n masks the slots
    const int st = hf[r];
    bool hit = false;
    if (quads) {
      const uint4* q = reinterpret_cast<const uint4*>(slots + b);
      const int n = (st & DISTINCT_FULL) ? w : st;  // the valid slots
      for (int j = 0; j < w; j += 4) {
        const uint4 u = q[j >> 2];
        hit |= (u.x == v && j < n) | (u.y == v && j + 1 < n) |
               (u.z == v && j + 2 < n) | (u.w == v && j + 3 < n);
      }
    } else {
      const int n = (st & DISTINCT_FULL) ? w : st;
      for (int j = 0; j < n; ++j) hit |= slots[b + j] == v;
    }
    hit &= can;
    // the next chunk's key, hit rule and row (of its entry alone), and the
    // entry of the one after it
    bool can1;
    const uint32_t v1 = distinct_key(bits1, fmode, &can1);
    const int r1 = cheetah_hash_mod(bits1, d, seed);
    const uint32_t bits2 = c + 2 < nchunks ? ring.next() : 0u;
    keep[base + static_cast<long long>(c) * B + t] = !hit;
    if (!hit) atomicMin(&first[r], t);
    __syncthreads();
    // The row's first miss inserts and re-arms first[r]; any other miss of
    // the row reads either its winner or the re-armed value, never its own
    // t. Only the owner writes hf[r] in a step, so st is still its value.
    if (!hit && first[r] == t) {
      const int h = st & ~DISTINCT_FULL;
      slots[b + h] = v;
      hf[r] = h + 1 == w ? DISTINCT_FULL : (st & DISTINCT_FULL) | (h + 1);
      first[r] = B;
    }
    __syncthreads();
    v = v1;
    can = can1;
    r = r1;
    bits1 = bits2;
  }
  rowpar_wait_all();
  const long long so = static_cast<long long>(blockIdx.x) * d * w;
  for (int k = t; k < d * w; k += B) {
    const int st = hf[k / w];
    slots_out[so + k] = slots[k];
    valid_out[so + k] = (st & DISTINCT_FULL) || k % w < st;
  }
  for (int k = t; k < d; k += B)
    head_out[static_cast<long long>(blockIdx.x) * d + k] =
        hf[k] & ~DISTINCT_FULL;
}

// Flags the entries of the partitioned stream that the walk must take, and
// drops the rest: at B = 1 an entry whose segment predecessor has the same
// key and which can hit (keep = 0); at B > 1 an entry whose segment
// predecessor has the same key, the same hit rule and the same block (its
// keep is filled in after the walk). flags has m + 1 ints; the last is set
// to 0.
__global__ void distinct_mark(const uint2* __restrict__ part,
                              int* __restrict__ flags,
                              uint8_t* __restrict__ keep, long long m,
                              int shard_len, int d, uint32_t seed, int fmode,
                              int block) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    bool dup = false;
    const uint2 e1 = part[j];
    if (j > 0) {
      const uint2 e0 = part[j - 1];
      if (e1.y / shard_len == e0.y / shard_len &&
          cheetah_hash_mod(e1.x, d, seed) == cheetah_hash_mod(e0.x, d, seed)) {
        bool can1, can0;
        const uint32_t k1 = distinct_key(e1.x, fmode, &can1);
        const uint32_t k0 = distinct_key(e0.x, fmode, &can0);
        dup = block == 1 ? can1 && k1 == k0
                         : k1 == k0 && can1 == can0 &&
                               (e1.y % shard_len) / block ==
                                   (e0.y % shard_len) / block;
      }
    }
    flags[j] = !dup;
    if (dup && block == 1) keep[e1.y] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[m] = 0;
}

// The flagged entries, compacted in order: the stored key, and the index
// (B = 1) or the block id (B > 1) with the sign bit set when the entry
// cannot hit. pos is the exclusive scan of the flags (m + 1 ints).
__global__ void distinct_compact(const uint2* __restrict__ part,
                                 const int* __restrict__ pos,
                                 uint2* __restrict__ walk, long long m,
                                 int shard_len, int fmode, int block) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride) {
    const int c = pos[j];
    if (pos[j + 1] == c) continue;
    const uint2 e = part[j];
    bool can;
    const uint32_t k = distinct_key(e.x, fmode, &can);
    const uint32_t tag =
        block == 1 ? e.y : (e.y % static_cast<uint32_t>(shard_len)) / block;
    walk[c] = make_uint2(k, tag | (can ? 0u : ROWPAR_INVALID));
  }
}

// One step of a row: the entry's key v (can: it may hit) against the w
// slots s (valid flags vm, FIFO head); returns keep = miss.
template <int W, bool kLru>
__device__ __forceinline__ bool distinct_step(uint32_t (&s)[W], unsigned& vm,
                                              int& head, uint32_t v, bool can,
                                              int w) {
  int hp = W;
#pragma unroll
  for (int i = W - 1; i >= 0; --i)
    if (((vm >> i) & 1u) && s[i] == v) hp = i;
  const bool hit = can && hp < W;
  if constexpr (kLru) {
    const int lim = hit ? hp : w - 1;
#pragma unroll
    for (int i = W - 1; i >= 1; --i)
      if (i <= lim) s[i] = s[i - 1];
    s[0] = v;
    const unsigned low = (2u << lim) - 1u;  // bits 0..lim
    vm = (vm & ~low) | (((vm << 1) | 1u) & low);
  } else if (!hit) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (i == head) s[i] = v;
    vm |= 1u << head;
    head = head + 1 == w ? 0 : head + 1;
  }
  return !hit;
}

// One warp walks one segment, its compacted entries [lo, hi) loaded
// through the warp's cp.async ring of rowpar.cuh. W >= w bounds the
// registers. keep: by the entry's index; *_row: the row's slots, of which
// wout are written (w, or the batch's padded width: slots past w as 0,
// never valid), and its head.
template <int W, bool kLru>
__device__ __forceinline__ void distinct_walk_seg(
    uint2 (*ring)[32], const uint2* __restrict__ walk, int lo, int hi,
    uint8_t* __restrict__ keep, uint32_t* __restrict__ slots_row,
    uint8_t* __restrict__ valid_row, int* __restrict__ head_row, int w,
    int wout, int resume, int lane) {
  const int chunks = (hi - lo + 31) >> 5;
  auto issue = [&](int c) {
    const int j = lo + (c << 5) + lane;
    const bool in = c < chunks && j < hi;
    rowpar_cp<8>(&ring[c % ROWPAR_STAGES][lane], walk + (in ? j : 0), in);
    rowpar_commit();
  };
  for (int c = 0; c < ROWPAR_STAGES - 1; ++c) issue(c);
  uint32_t s[W];
  unsigned vm = 0u;  // valid flags, bit i for slot i
  // a resumed walk starts from the row's carried slots, flags and head
  // (read here, before this warp writes the row back at its end)
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const bool in = resume && i < w;
    s[i] = in ? slots_row[i] : 0u;
    if (in && valid_row[i]) vm |= 1u << i;
  }
  int head = resume ? *head_row : 0;
  for (int c = 0; c < chunks; ++c) {
    __syncwarp();  // every lane is done with the slot this issue refills
    issue(c + ROWPAR_STAGES - 1);
    rowpar_wait();
    __syncwarp();  // every lane's copy of chunk c is visible to the warp
    const uint2* ch = ring[c % ROWPAR_STAGES];
    const int n = min(32, hi - lo - (c << 5));
    bool mine = false;
    if (n == 32) {  // unrolled: the broadcast reads run ahead of the chain
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const uint2 x = ch[e];
        const bool kp = distinct_step<W, kLru>(s, vm, head, x.x,
                                               static_cast<int>(x.y) >= 0, w);
        if (lane == e) mine = kp;
      }
    } else {
      for (int e = 0; e < n; ++e) {
        const uint2 x = ch[e];
        const bool kp = distinct_step<W, kLru>(s, vm, head, x.x,
                                               static_cast<int>(x.y) >= 0, w);
        if (lane == e) mine = kp;
      }
    }
    if (lane < n) keep[ch[lane].y & 0x7FFFFFFF] = mine;
  }
  rowpar_wait_all();
  for (int i = lane; i < wout; i += 32) {
    uint32_t v = 0u;
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c == i && c < w) v = s[c];
    slots_row[i] = v;
    valid_row[i] = (vm >> i) & 1u;
  }
  if (lane == 0) *head_row = head;
}

// One warp a segment g = lane * d + row over its compacted entries
// [pos[starts[g]], pos[starts[g + 1]]).
template <int W, bool kLru>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    distinct_walk(const uint2* __restrict__ walk, const int* __restrict__ pos,
                  const int* __restrict__ starts, uint8_t* __restrict__ keep,
                  uint32_t* __restrict__ slots_out,
                  uint8_t* __restrict__ valid_out, int* __restrict__ head_out,
                  long long nseg, int w, int resume) {
  __shared__ uint2 ring[ROWPAR_WARPS][ROWPAR_STAGES][32];
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= nseg) return;  // whole warps
  distinct_walk_seg<W, kLru>(ring[threadIdx.x >> 5], walk, pos[starts[g]],
                             pos[starts[g + 1]], keep, slots_out + g * w,
                             valid_out + g * w, head_out + g, w, w, resume,
                             threadIdx.x & 31);
}

template <int W>
void distinct_walk_launch(const uint2* walk, const int* pos,
                          const int* starts, uint8_t* keep, uint32_t* slots,
                          uint8_t* valid, int* head, long long nseg, int w,
                          int lru, int resume, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nseg * 32 + ROWPAR_THREADS - 1) /
                                                ROWPAR_THREADS);
  if (lru)
    distinct_walk<W, true><<<blocks, ROWPAR_THREADS, 0, stream>>>(
        walk, pos, starts, keep, slots, valid, head, nseg, w, resume);
  else
    distinct_walk<W, false><<<blocks, ROWPAR_THREADS, 0, stream>>>(
        walk, pos, starts, keep, slots, valid, head, nseg, w, resume);
}

// The walk for rows wider than a warp's registers (w > 32): one warp a
// segment as above, the row's slots and valid flags in shared memory, its
// entries loaded 32 at a time (one a lane) and broadcast by shuffles. A
// step probes the row lane-strided and takes the first hit with a warp min.
template <bool kLru>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    distinct_walk_wide(const uint2* __restrict__ walk,
                       const int* __restrict__ pos,
                       const int* __restrict__ starts,
                       uint8_t* __restrict__ keep,
                       uint32_t* __restrict__ slots_out,
                       uint8_t* __restrict__ valid_out,
                       int* __restrict__ head_out, long long nseg, int w,
                       int resume) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * warps + warp;
  if (g >= nseg) return;  // whole warps
  uint32_t* s = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * w;
  uint8_t* vb = smem + static_cast<size_t>(warps) * w * sizeof(uint32_t) +
                static_cast<size_t>(warp) * w;
  for (int i = lane; i < w; i += 32) {
    s[i] = resume ? slots_out[g * w + i] : 0u;
    vb[i] = resume ? valid_out[g * w + i] : 0;
  }
  __syncwarp();
  const int lo = pos[starts[g]];
  const int hi = pos[starts[g + 1]];
  int head = resume ? head_out[g] : 0;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int n = min(32, hi - c0);
    const uint2 en = lane < n ? walk[c0 + lane] : make_uint2(0u, 0u);
    bool mine = false;
    for (int e = 0; e < n; ++e) {
      const uint32_t v = __shfl_sync(ROWPAR_FULL, en.x, e);
      const bool can = static_cast<int>(__shfl_sync(ROWPAR_FULL, en.y, e)) >= 0;
      const int hp = rowpar_first_hit(s, vb, w, v, lane);
      const bool hit = can && hp < w;
      if constexpr (kLru) {
        const int lim = hit ? hp : w - 1;
        rowpar_shift(s, lim, lane);
        rowpar_shift(vb, lim, lane);
        if (lane == 0) {
          s[0] = v;
          vb[0] = 1;
        }
      } else if (!hit) {
        if (lane == 0) {
          s[head] = v;
          vb[head] = 1;
        }
        head = head + 1 == w ? 0 : head + 1;
      }
      __syncwarp();
      if (lane == e) mine = !hit;
    }
    if (lane < n) keep[en.y & 0x7FFFFFFF] = mine;
  }
  const long long o = g * w;
  for (int i = lane; i < w; i += 32) {
    slots_out[o + i] = s[i];
    valid_out[o + i] = vb[i];
  }
  if (lane == 0) head_out[g] = head;
}

cudaError_t distinct_walk_wide_launch(const uint2* walk, const int* pos,
                                      const int* starts, uint8_t* keep,
                                      uint32_t* slots, uint8_t* valid,
                                      int* head, long long nseg, int w,
                                      int lru, int resume,
                                      cudaStream_t stream) {
  const size_t row = static_cast<size_t>(w) * (sizeof(uint32_t) + 1);
  const int warps = rowpar_wide_warps(row);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = warps * row;
  const unsigned blocks = static_cast<unsigned>((nseg + warps - 1) / warps);
  const void* fn = lru ? reinterpret_cast<const void*>(distinct_walk_wide<true>)
                       : reinterpret_cast<const void*>(distinct_walk_wide<false>);
  cudaError_t err = cheetah_launch_prep(fn, smem);
  if (err != cudaSuccess) return err;
  if (lru)
    distinct_walk_wide<true><<<blocks, warps * 32, smem, stream>>>(
        walk, pos, starts, keep, slots, valid, head, nseg, w, resume);
  else
    distinct_walk_wide<false><<<blocks, warps * 32, smem, stream>>>(
        walk, pos, starts, keep, slots, valid, head, nseg, w, resume);
  return cudaGetLastError();
}

// B > 1: one warp a segment g over its compacted entries [pos[starts[g]],
// pos[starts[g + 1]]) of (key, block id), through a ring of ROWPAR_STAGES
// chunks of 32 in shared memory, refilled by cp.async as the windows move
// on (a window of 32 from the first unresolved entry spans at most two
// chunks). The row's slots live in registers of every lane (W >= w).
// ckeep gets each compacted entry's keep.
template <int W>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    distinct_block_walk(const uint2* __restrict__ walk,
                        const int* __restrict__ pos,
                        const int* __restrict__ starts,
                        uint8_t* __restrict__ ckeep,
                        uint32_t* __restrict__ slots_out,
                        uint8_t* __restrict__ valid_out,
                        int* __restrict__ head_out, long long nseg, int w) {
  constexpr int kRing = ROWPAR_STAGES * 32;
  __shared__ uint2 ring[ROWPAR_WARPS][kRing];
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= nseg) return;  // whole warps
  const int lane = threadIdx.x & 31;
  uint2* rw = ring[threadIdx.x >> 5];
  const int lo = pos[starts[g]];
  const int len = pos[starts[g + 1]] - lo;
  const int chunks = (len + 31) >> 5;
  auto issue = [&](int c) {
    const int j = (c << 5) + lane;
    const bool in = c < chunks && j < len;
    rowpar_cp<8>(&rw[(c % ROWPAR_STAGES) * 32 + lane], walk + (in ? lo + j : 0),
                 in);
    rowpar_commit();
  };
  for (int c = 0; c < ROWPAR_STAGES; ++c) issue(c);
  uint32_t s[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = 0u;
  unsigned vm = 0u;  // valid flags, bit i for slot i
  int head = 0;
  // the group that inserted last, and what its insert overwrote
  uint32_t g_ins = 0xFFFFFFFFu;
  int h_ins = 0;
  uint32_t k_ins = 0u;
  bool v_ins = false;
  int done = 0;  // chunks consumed, their ring slots refilled
  for (int rel = 0; rel < len;) {
    for (; done < (rel >> 5); ++done) {
      __syncwarp();  // every lane is done with the slot this issue refills
      issue(done + ROWPAR_STAGES);
    }
    rowpar_wait_for<ROWPAR_STAGES - 2>();  // chunks up to (rel >> 5) + 1
    __syncwarp();
    const bool in = rel + lane < len;
    const uint2 x = rw[(rel + lane) % kRing];
    const uint32_t key = x.x;
    const uint32_t blk = x.y & 0x7FFFFFFFu;
    unsigned hb = 0u;
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (((vm >> i) & 1u) && s[i] == key) hb |= 1u << i;
    const bool pre = blk == g_ins;
    const bool hit =
        static_cast<int>(x.y) >= 0 &&
        (pre ? (hb & ~(1u << h_ins)) != 0u || (v_ins && k_ins == key)
             : hb != 0u);
    const unsigned cand = __ballot_sync(ROWPAR_FULL, in && !pre && !hit);
    int n = min(32, len - rel);
    if (cand) {
      const int f = __ffs(cand) - 1;
      const uint32_t gf = __shfl_sync(ROWPAR_FULL, blk, f);
      const uint32_t kf = __shfl_sync(ROWPAR_FULL, key, f);
      n = __popc(__ballot_sync(ROWPAR_FULL, in && blk <= gf));
      h_ins = head;
      v_ins = (vm >> head) & 1u;
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (i == head) {
          k_ins = s[i];
          s[i] = kf;
        }
      vm |= 1u << head;
      head = head + 1 == w ? 0 : head + 1;
      g_ins = gf;
    }
    if (lane < n) ckeep[lo + rel + lane] = !hit;
    rel += n;
  }
  rowpar_wait_all();
  const long long o = g * w;
  for (int i = lane; i < w; i += 32) {
    uint32_t v = 0u;
#pragma unroll
    for (int c = 0; c < W; ++c)
      if (c == i) v = s[c];
    slots_out[o + i] = v;
    valid_out[o + i] = (vm >> i) & 1u;
  }
  if (lane == 0) head_out[g] = head;
}

template <int W>
void distinct_block_walk_launch(const uint2* walk, const int* pos,
                                const int* starts, uint8_t* ckeep,
                                uint32_t* slots, uint8_t* valid, int* head,
                                long long nseg, int w, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((nseg * 32 + ROWPAR_THREADS - 1) /
                                                ROWPAR_THREADS);
  distinct_block_walk<W><<<blocks, ROWPAR_THREADS, 0, stream>>>(
      walk, pos, starts, ckeep, slots, valid, head, nseg, w);
}

// The block walk for rows wider than a warp's registers (w > 32): the
// row's slots and valid flags in shared memory, each window loaded from
// global memory (one entry a lane); every lane probes the whole row for
// its own entry.
__global__ void __launch_bounds__(ROWPAR_THREADS)
    distinct_block_walk_wide(const uint2* __restrict__ walk,
                             const int* __restrict__ pos,
                             const int* __restrict__ starts,
                             uint8_t* __restrict__ ckeep,
                             uint32_t* __restrict__ slots_out,
                             uint8_t* __restrict__ valid_out,
                             int* __restrict__ head_out, long long nseg,
                             int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * warps + warp;
  if (g >= nseg) return;  // whole warps
  uint32_t* s = reinterpret_cast<uint32_t*>(smem) + static_cast<size_t>(warp) * w;
  uint8_t* vb = smem + static_cast<size_t>(warps) * w * sizeof(uint32_t) +
                static_cast<size_t>(warp) * w;
  for (int i = lane; i < w; i += 32) {
    s[i] = 0u;
    vb[i] = 0;
  }
  __syncwarp();
  const int lo = pos[starts[g]];
  const int len = pos[starts[g + 1]] - lo;
  int head = 0;
  uint32_t g_ins = 0xFFFFFFFFu;
  int h_ins = 0;
  uint32_t k_ins = 0u;
  bool v_ins = false;
  for (int rel = 0; rel < len;) {
    const bool in = rel + lane < len;
    const uint2 x = in ? walk[lo + rel + lane] : make_uint2(0u, 0u);
    const uint32_t key = x.x;
    const uint32_t blk = x.y & 0x7FFFFFFFu;
    const bool pre = blk == g_ins;
    bool hit = pre && v_ins && k_ins == key;
    for (int i = 0; i < w && !hit; ++i)
      hit = vb[i] && s[i] == key && !(pre && i == h_ins);
    hit = hit && static_cast<int>(x.y) >= 0;
    const unsigned cand = __ballot_sync(ROWPAR_FULL, in && !pre && !hit);
    int n = min(32, len - rel);
    if (cand) {
      const int f = __ffs(cand) - 1;
      const uint32_t gf = __shfl_sync(ROWPAR_FULL, blk, f);
      const uint32_t kf = __shfl_sync(ROWPAR_FULL, key, f);
      n = __popc(__ballot_sync(ROWPAR_FULL, in && blk <= gf));
      h_ins = head;
      v_ins = vb[head] != 0;
      k_ins = s[head];
      __syncwarp();  // every lane has probed and read the slot
      if (lane == 0) {
        s[head] = kf;
        vb[head] = 1;
      }
      __syncwarp();
      head = head + 1 == w ? 0 : head + 1;
      g_ins = gf;
    }
    if (lane < n) ckeep[lo + rel + lane] = !hit;
    rel += n;
  }
  const long long o = g * w;
  for (int i = lane; i < w; i += 32) {
    slots_out[o + i] = s[i];
    valid_out[o + i] = vb[i];
  }
  if (lane == 0) head_out[g] = head;
}

cudaError_t distinct_block_walk_wide_launch(const uint2* walk, const int* pos,
                                            const int* starts, uint8_t* ckeep,
                                            uint32_t* slots, uint8_t* valid,
                                            int* head, long long nseg, int w,
                                            cudaStream_t stream) {
  const size_t row = static_cast<size_t>(w) * (sizeof(uint32_t) + 1);
  const int warps = rowpar_wide_warps(row);
  if (warps == 0) return cudaErrorInvalidValue;
  const size_t smem = warps * row;
  const unsigned blocks = static_cast<unsigned>((nseg + warps - 1) / warps);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(distinct_block_walk_wide), smem);
  if (err != cudaSuccess) return err;
  distinct_block_walk_wide<<<blocks, warps * 32, smem, stream>>>(
      walk, pos, starts, ckeep, slots, valid, head, nseg, w);
  return cudaGetLastError();
}

// B > 1: each entry's keep from the compacted keep of its own entry or, for
// a dropped same-block repeat, of the entry it repeats; both are the last
// compacted entry at or before it, pos[j + 1] - 1.
__global__ void distinct_fill(const uint2* __restrict__ part,
                              const int* __restrict__ pos,
                              const uint8_t* __restrict__ ckeep,
                              uint8_t* __restrict__ keep, long long m) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < m; j += stride)
    keep[part[j].y] = ckeep[pos[j + 1] - 1];
}

// The lowest-owner table of distinct_apply: per row of the [d][S*w] union, an
// open-addressed table of T = 2^tbits >= 2 * S * w slots, each the packed
// (owner << 32 | key) of a key held in a valid slot of the row, owner the
// lowest shard that holds it; OWNER_EMPTY marks a free slot (no shard is
// 2^32 - 1). A key's probe starts at the top tbits of its own mix and moves
// by one slot; at most half the slots are taken, so a probe ends.
#define OWNER_EMPTY 0xFFFFFFFFFFFFFFFFull
#define OWNER_SEED 0x9E3779B9u

__device__ __forceinline__ unsigned owner_home(uint32_t key, int tbits) {
  return cheetah_mix32(key, OWNER_SEED) >> (32 - tbits);
}

// One CTA a row: the row's valid columns c (owner c / w) go into the table,
// in shared memory when kSmem (then written out once), else in place.
template <bool kSmem>
__global__ void distinct_owner_build(const uint32_t* __restrict__ mslots,
                                     const uint8_t* __restrict__ mvalid,
                                     unsigned long long* __restrict__ table,
                                     int w, int sw, int tbits) {
  extern __shared__ unsigned long long tsm[];
  const int T = 1 << tbits;
  const long long row = blockIdx.x;
  unsigned long long* out = table + (row << tbits);
  unsigned long long* t = kSmem ? tsm : out;
  for (int i = threadIdx.x; i < T; i += blockDim.x) t[i] = OWNER_EMPTY;
  __syncthreads();
  for (int c = threadIdx.x; c < sw; c += blockDim.x) {
    if (!mvalid[row * sw + c]) continue;
    const uint32_t key = mslots[row * sw + c];
    const unsigned long long e =
        static_cast<unsigned long long>(c / w) << 32 | key;
    for (unsigned h = owner_home(key, tbits);; h = (h + 1) & (T - 1)) {
      const unsigned long long old = atomicCAS(&t[h], OWNER_EMPTY, e);
      if (old == OWNER_EMPTY) break;
      if (static_cast<uint32_t>(old) == key) {  // same key: the lower owner
        atomicMin(&t[h], e);
        break;
      }
    }
  }
  if (kSmem) {
    __syncthreads();
    for (int i = threadIdx.x; i < T; i += blockDim.x) out[i] = t[i];
  }
}

// The lowest shard whose valid slot of the row holds key, or 2^32 - 1.
__device__ __forceinline__ long long owner_of(
    const unsigned long long* __restrict__ t, uint32_t key, int tbits) {
  const unsigned mask = (1u << tbits) - 1u;
  for (unsigned h = owner_home(key, tbits);; h = (h + 1) & mask) {
    const unsigned long long e = t[h];
    if (e == OWNER_EMPTY || static_cast<uint32_t>(e) == key)
      return static_cast<long long>(e >> 32);
  }
}

#define OWNER_RUN 16  // entries a thread of distinct_owner_apply takes

// Each thread takes OWNER_RUN consecutive entries: keep1 read and keep
// written as 16 bytes where aligned, the lane found once for the run. A
// pass-1 survivor that can hit makes one lookup and is dropped iff a lower
// shard owns its key. x holds the lanes [lane0, lane0 + m / shard_len) of
// the union's lanes (a mesh position's own), so local lane s is lane0 + s.
__global__ void distinct_owner_apply(const uint32_t* __restrict__ x,
                                     const uint8_t* __restrict__ keep1,
                                     const unsigned long long* __restrict__ table,
                                     uint8_t* __restrict__ keep, long long m,
                                     int shard_len, int d, int tbits,
                                     uint32_t seed, int fmode,
                                     long long lane0) {
  const long long runs = (m + OWNER_RUN - 1) / OWNER_RUN;
  const bool vec = ((reinterpret_cast<uintptr_t>(keep1) |
                     reinterpret_cast<uintptr_t>(keep)) & 15) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < runs; q += stride) {
    const long long i0 = q * OWNER_RUN;
    const int n = static_cast<int>(min(static_cast<long long>(OWNER_RUN), m - i0));
    const bool whole = vec && n == OWNER_RUN;
    // the run's keep1 bytes, four to a word (constant indices throughout,
    // so that kw stays in registers)
    unsigned kw[4] = {0u, 0u, 0u, 0u};
    if (whole) {
      const uint4 kv = *reinterpret_cast<const uint4*>(keep1 + i0);
      kw[0] = kv.x;
      kw[1] = kv.y;
      kw[2] = kv.z;
      kw[3] = kv.w;
    } else {
#pragma unroll
      for (int j = 0; j < OWNER_RUN; ++j)
        if (j < n) kw[j >> 2] |= unsigned(keep1[i0 + j]) << (j & 3) * 8;
    }
    long long lane = i0 / shard_len;
    long long next = (lane + 1) * shard_len;
    lane += lane0;
#pragma unroll
    for (int j = 0; j < OWNER_RUN; ++j) {
      if (i0 + j == next) {
        ++lane;
        next += shard_len;
      }
      const int sh = (j & 3) * 8;
      if (!((kw[j >> 2] >> sh) & 0xFFu)) continue;
      const uint32_t bits = x[i0 + j];
      bool can;
      const uint32_t v = distinct_key(bits, fmode, &can);
      if (!can) continue;
      const long long row = cheetah_hash_mod(bits, d, seed);
      if (owner_of(table + (row << tbits), v, tbits) < lane)
        kw[j >> 2] &= ~(0xFFu << sh);
    }
    if (whole) {
      *reinterpret_cast<uint4*>(keep + i0) = make_uint4(kw[0], kw[1], kw[2], kw[3]);
    } else {
#pragma unroll
      for (int j = 0; j < OWNER_RUN; ++j)
        if (j < n) keep[i0 + j] = (kw[j >> 2] >> (j & 3) * 8) & 0xFFu;
    }
  }
}

// log2 of the lowest-owner table's slots a row: a power of two >= 2 * sw.
int owner_bits(int sw) {
  int b = 1;
  while ((1LL << b) < 2LL * sw) ++b;
  return b;
}

// The kernel distinct_apply replaced: each pass-1 survivor of lane s probes
// the columns [0, s * w) of its row in the union.
__global__ void distinct_apply_kernel(const uint32_t* __restrict__ x,
                                      const uint8_t* __restrict__ keep1,
                                      const uint32_t* __restrict__ mslots,
                                      const uint8_t* __restrict__ mvalid,
                                      uint8_t* __restrict__ keep, long long m,
                                      int shard_len, int d, int w, int sw,
                                      uint32_t seed, int fmode) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    if (!keep1[i]) {
      keep[i] = 0;
      continue;
    }
    const uint32_t bits = x[i];
    bool can;
    const uint32_t v = distinct_key(bits, fmode, &can);
    const long long row = cheetah_hash_mod(bits, d, seed);
    const uint32_t* rs = mslots + row * sw;
    const uint8_t* rv = mvalid + row * sw;
    const int ncols = can ? static_cast<int>(i / shard_len) * w : 0;
    bool dup = false;
    for (int c = 0; c < ncols && !dup; ++c) dup = rv[c] && rs[c] == v;
    keep[i] = !dup;
  }
}

struct DistinctWork {
  RowparPlan plan;
  size_t partition, part, flags, partial, ckeep, total;
};

DistinctWork distinct_work(int shards, int shard_len, int d) {
  DistinctWork k;
  k.plan = rowpar_plan(shards, shard_len, d);
  const long long m = static_cast<long long>(shards) * shard_len;
  k.partition = rowpar_partition_bytes(k.plan);
  k.part = rowpar_align(m * sizeof(uint2));
  k.flags = rowpar_align((m + 1) * sizeof(int));
  k.partial = rowpar_align((rowpar_scan_blocks(m + 1) + 1) * sizeof(int));
  k.ckeep = rowpar_align(m);
  // partition scratch; the partitioned stream; the compacted stream; the
  // flags and their scan's partials; the compacted keep (B > 1)
  k.total = k.partition + 2 * k.part + k.flags + k.partial + k.ckeep;
  return k;
}

// The walks of both semantics: partition, collapse, compact, then one warp
// a segment (B = 1: FIFO or LRU, keep written by the walk; B > 1: FIFO
// block semantics, keep filled from the compacted keep). work holds
// distinct_work(...).total bytes.
cudaError_t distinct_walks(const uint32_t* x, uint8_t* keep, uint32_t* slots,
                           uint8_t* valid, int* head, int shards,
                           int shard_len, int d, int w, int block, int lru,
                           int fmode, uint32_t seed, unsigned char* work,
                           int resume, cudaStream_t stream) {
  if (w < 1 || block < 1 || (resume && block > 1) ||
      (w > 32 && rowpar_wide_warps(static_cast<size_t>(w) * 5) == 0))
    return cudaErrorInvalidValue;
  const DistinctWork k = distinct_work(shards, shard_len, d);
  const long long m = static_cast<long long>(shards) * shard_len;
  const long long nseg = static_cast<long long>(shards) * d;
  unsigned char* p = work + k.partition;
  uint2* part = reinterpret_cast<uint2*>(p);
  uint2* walk = reinterpret_cast<uint2*>(p + k.part);
  int* flags = reinterpret_cast<int*>(p + 2 * k.part);
  int* partial = reinterpret_cast<int*>(p + 2 * k.part + k.flags);
  uint8_t* ckeep = p + 2 * k.part + k.flags + k.partial;
  int* starts = nullptr;
  cudaError_t err = rowpar_partition(x, nullptr, nullptr, k.plan, seed, part,
                                     work, &starts, stream);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(
      min((m + ROWPAR_THREADS - 1) / ROWPAR_THREADS, 132LL * 16));
  distinct_mark<<<grid, ROWPAR_THREADS, 0, stream>>>(
      part, flags, keep, m, shard_len, d, seed, fmode, block);
  err = rowpar_scan(flags, m + 1, partial, stream);
  if (err != cudaSuccess) return err;
  distinct_compact<<<grid, ROWPAR_THREADS, 0, stream>>>(part, flags, walk, m,
                                                        shard_len, fmode,
                                                        block);
  if (block > 1) {
    if (w <= 4)
      distinct_block_walk_launch<4>(walk, flags, starts, ckeep, slots, valid,
                                    head, nseg, w, stream);
    else if (w <= 8)
      distinct_block_walk_launch<8>(walk, flags, starts, ckeep, slots, valid,
                                    head, nseg, w, stream);
    else if (w <= 16)
      distinct_block_walk_launch<16>(walk, flags, starts, ckeep, slots, valid,
                                     head, nseg, w, stream);
    else if (w <= 32)
      distinct_block_walk_launch<32>(walk, flags, starts, ckeep, slots, valid,
                                     head, nseg, w, stream);
    else if ((err = distinct_block_walk_wide_launch(
                  walk, flags, starts, ckeep, slots, valid, head, nseg, w,
                  stream)) != cudaSuccess)
      return err;
    distinct_fill<<<grid, ROWPAR_THREADS, 0, stream>>>(part, flags, ckeep,
                                                       keep, m);
    return cudaGetLastError();
  }
  if (w <= 4)
    distinct_walk_launch<4>(walk, flags, starts, keep, slots, valid, head,
                            nseg, w, lru, resume, stream);
  else if (w <= 8)
    distinct_walk_launch<8>(walk, flags, starts, keep, slots, valid, head,
                            nseg, w, lru, resume, stream);
  else if (w <= 16)
    distinct_walk_launch<16>(walk, flags, starts, keep, slots, valid, head,
                             nseg, w, lru, resume, stream);
  else if (w <= 32)
    distinct_walk_launch<32>(walk, flags, starts, keep, slots, valid, head,
                             nseg, w, lru, resume, stream);
  else
    return distinct_walk_wide_launch(walk, flags, starts, keep, slots, valid,
                                     head, nseg, w, lru, resume, stream);
  return cudaGetLastError();
}

size_t serial_smem(int d, int w) {
  return static_cast<size_t>(d) * w * (sizeof(uint32_t) + 1) +
         static_cast<size_t>(d) * sizeof(int) +
         CHEETAH_STAGE * (sizeof(uint32_t) + sizeof(int) + 1);
}

// The batched walk (distinct_pass1_batch, B = 1, FIFO or LRU): a wave of
// queries partitioned on the query axis (rowpar_partition_q); the repeats
// dropped as for one query (distinct_mark_q: the predecessor of the same
// query, lane and row, with the query's d and seed), the rest compacted
// (distinct_compact); then one warp a (query, lane, row) segment takes the
// walk of distinct_walk with its query's w, and writes the row into the
// padded state [Q][S][dcap][wcap]: slots past w are 0 and never valid, as
// the reference's batched pads. keep is [Q][m].
__global__ void distinct_mark_q(const uint2* __restrict__ part,
                                int* __restrict__ flags,
                                uint8_t* __restrict__ keep, RowparQ p,
                                int fmode) {
  const long long m = static_cast<long long>(p.shards) * p.shard_len;
  const long long total = p.nq * m;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < total; j += stride) {
    bool dup = false;
    const uint2 e1 = part[j];
    const int q = static_cast<int>(j / m);
    if (j % m) {
      const uint2 e0 = part[j - 1];
      if (e1.y / p.shard_len == e0.y / p.shard_len &&
          cheetah_hash_mod(e1.x, p.d[q], p.seed[q]) ==
              cheetah_hash_mod(e0.x, p.d[q], p.seed[q])) {
        bool can1, can0;
        const uint32_t k1 = distinct_key(e1.x, fmode, &can1);
        const uint32_t k0 = distinct_key(e0.x, fmode, &can0);
        dup = can1 && k1 == k0;
      }
    }
    flags[j] = !dup;
    if (dup) keep[q * m + e1.y] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[total] = 0;
}

template <int W, bool kLru>
__global__ void __launch_bounds__(ROWPAR_THREADS)
    distinct_walk_q(const uint2* __restrict__ walk, const int* __restrict__ pos,
                    const int* __restrict__ starts,
                    uint8_t* __restrict__ keep, uint32_t* __restrict__ slots_out,
                    uint8_t* __restrict__ valid_out, int* __restrict__ head_out,
                    RowparQ p) {
  __shared__ uint2 ring[ROWPAR_WARPS][ROWPAR_STAGES][32];
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= p.nseg) return;  // whole warps
  int q, sl, row;
  rowpar_segment_q(p, g, &q, &sl, &row);
  const long long o = rowpar_slot_q(p, q, sl, row);
  distinct_walk_seg<W, kLru>(
      ring[threadIdx.x >> 5], walk, pos[starts[g]], pos[starts[g + 1]],
      keep + static_cast<long long>(q) * p.shards * p.shard_len,
      slots_out + o, valid_out + o,
      head_out + (static_cast<long long>(q) * p.shards + sl) * p.dcap + row,
      p.w[q], p.wcap, 0, threadIdx.x & 31);
}

template <int W>
void distinct_walk_q_launch(const uint2* walk, const int* pos,
                            const int* starts, uint8_t* keep, uint32_t* slots,
                            uint8_t* valid, int* head, const RowparQ& p,
                            int lru, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(
      (p.nseg * 32 + ROWPAR_THREADS - 1) / ROWPAR_THREADS);
  if (lru)
    distinct_walk_q<W, true><<<blocks, ROWPAR_THREADS, 0, stream>>>(
        walk, pos, starts, keep, slots, valid, head, p);
  else
    distinct_walk_q<W, false><<<blocks, ROWPAR_THREADS, 0, stream>>>(
        walk, pos, starts, keep, slots, valid, head, p);
}

// The batched walk's workspace: the query-axis partition's scratch, the
// nq * m partitioned entries, their flags and the scan's partials, and
// the compacted entries.
struct DistinctBatchWork {
  RowparQ plan;
  size_t part, flags, partial, walk, total;
};

DistinctBatchWork distinct_batch_work(int nq, int shards, int shard_len,
                                      const int* d, const int* w,
                                      const uint32_t* seed, int dcap,
                                      int wcap) {
  DistinctBatchWork k;
  k.plan = rowpar_plan_q(nq, shards, shard_len, d, w, seed, dcap, wcap);
  const long long n = static_cast<long long>(nq) * shards * shard_len;
  k.part = rowpar_partition_bytes_q(k.plan);
  k.flags = k.part + rowpar_align(n * sizeof(uint2));
  k.partial = k.flags + rowpar_align((n + 1) * sizeof(int));
  k.walk = k.partial + rowpar_align((rowpar_scan_blocks(n + 1) + 1) * sizeof(int));
  k.total = k.walk + rowpar_align(n * sizeof(uint2));
  return k;
}

// The block kernel's layout: the slots, the row states and first, the ring.
StagedPlan distinct_block_plan(int d, int w, int block) {
  return staged_plan(static_cast<size_t>(d) * w * sizeof(uint32_t) +
                         2 * static_cast<size_t>(d) * sizeof(int),
                     block);
}

}  // namespace

// Shared memory of the block kernel (B > 1), its ring included; the walks
// need none of it.
extern "C" size_t distinct_pass1_smem(int d, int w, int block) {
  return distinct_block_plan(d, w, block).total;
}

// Workspace of the walks (distinct_pass1 at B = 1, and the block walk); the
// block kernel takes none.
extern "C" size_t distinct_pass1_workspace(int shards, int shard_len, int d) {
  return distinct_work(shards, shard_len, d).total;
}

// B = 1: the row-parallel walk (FIFO or LRU); B > 1: the one-CTA-a-lane
// block kernel. resume (B = 1 only, the streaming fold): each row starts
// from the slots, valid flags and head the outputs hold.
extern "C" int distinct_pass1(const uint32_t* x, uint8_t* keep, uint32_t* slots,
                              uint8_t* valid, int* head, int shards,
                              int shard_len, int d, int w, int block, int lru,
                              int fmode, uint32_t seed, unsigned char* work,
                              int resume, cudaStream_t stream) {
  if (block > 1) {
    if (resume) return cudaErrorInvalidValue;
    if (lru) return cudaErrorInvalidValue;  // LRU is per entry: B = 1 only
    if (block > 1024 || shard_len % block) return cudaErrorInvalidValue;
    const StagedPlan p = distinct_block_plan(d, w, block);
    cudaError_t err = cheetah_launch_prep(
        reinterpret_cast<const void*>(distinct_pass1_block), p.total);
    if (err != cudaSuccess) return err;
    distinct_pass1_block<<<shards, block, p.total, stream>>>(
        x, keep, slots, valid, head, shard_len, d, w, fmode, seed, p.cps,
        p.stages, static_cast<int>(p.ring), static_cast<int>(p.slot));
    return cudaGetLastError();
  }
  return distinct_walks(x, keep, slots, valid, head, shards, shard_len, d, w,
                        1, lru, fmode, seed, work, resume, stream);
}

// The row-parallel block walk (FIFO, block semantics, B >= 1); work holds
// distinct_pass1_workspace bytes.
extern "C" int distinct_pass1_block_walk(const uint32_t* x, uint8_t* keep,
                                         uint32_t* slots, uint8_t* valid,
                                         int* head, int shards, int shard_len,
                                         int d, int w, int block, int fmode,
                                         uint32_t seed, unsigned char* work,
                                         cudaStream_t stream) {
  return distinct_walks(x, keep, slots, valid, head, shards, shard_len, d, w,
                        block, 0, fmode, seed, work, 0, stream);
}

// The retired block kernel (FIFO, B > 1), for holding the staged block
// kernel against it; launched by no entry point of the package.
extern "C" int distinct_pass1_block_unstaged(const uint32_t* x, uint8_t* keep,
                                             uint32_t* slots, uint8_t* valid,
                                             int* head, int shards,
                                             int shard_len, int d, int w,
                                             int block, int fmode,
                                             uint32_t seed,
                                             cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * w * (sizeof(uint32_t) + 1) +
                      2 * static_cast<size_t>(d) * sizeof(int);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(distinct_pass1_block_unstaged_kernel),
      smem);
  if (err != cudaSuccess) return err;
  distinct_pass1_block_unstaged_kernel<<<shards, block, smem, stream>>>(
      x, keep, slots, valid, head, shard_len, d, w, fmode, seed);
  return cudaGetLastError();
}

// The retired one-thread walk, for holding the row-parallel walk against it
// (uint32 keys only); launched by no entry point of the package.
extern "C" int distinct_pass1_serial(const uint32_t* x, uint8_t* keep,
                                     uint32_t* slots, uint8_t* valid,
                                     int* head, int shards, int shard_len,
                                     int d, int w, int lru, uint32_t seed,
                                     cudaStream_t stream) {
  const size_t smem = serial_smem(d, w);
  const void* fn = lru ? reinterpret_cast<const void*>(distinct_serial_kernel<true>)
                       : reinterpret_cast<const void*>(distinct_serial_kernel<false>);
  cudaError_t err = cheetah_launch_prep(fn, smem);
  if (err != cudaSuccess) return err;
  if (lru)
    distinct_serial_kernel<true><<<shards, CHEETAH_STAGE, smem, stream>>>(
        x, keep, slots, valid, head, shard_len, d, w, seed);
  else
    distinct_serial_kernel<false><<<shards, CHEETAH_STAGE, smem, stream>>>(
        x, keep, slots, valid, head, shard_len, d, w, seed);
  return cudaGetLastError();
}

// Bytes of distinct_apply's lowest-owner table.
extern "C" size_t distinct_apply_workspace(int d, int sw) {
  return static_cast<size_t>(d) * sizeof(unsigned long long) << owner_bits(sw);
}

// Build the lowest-owner table (work holds distinct_apply_workspace bytes),
// then apply it to every entry; x's first lane is lane lane0 of the union.
extern "C" int distinct_apply(const uint32_t* x, const uint8_t* keep1,
                              const uint32_t* mslots, const uint8_t* mvalid,
                              uint8_t* keep, long long m, int shard_len, int d,
                              int w, int sw, uint32_t seed, int fmode,
                              long long lane0, int grid, unsigned char* work,
                              cudaStream_t stream) {
  const int tbits = owner_bits(sw);
  const size_t smem = sizeof(unsigned long long) << tbits;
  auto* table = reinterpret_cast<unsigned long long*>(work);
  if (smem <= CHEETAH_MAX_SMEM) {
    cudaError_t err = cheetah_launch_prep(
        reinterpret_cast<const void*>(distinct_owner_build<true>), smem);
    if (err != cudaSuccess) return err;
    distinct_owner_build<true><<<d, 256, smem, stream>>>(mslots, mvalid, table,
                                                         w, sw, tbits);
  } else {
    distinct_owner_build<false><<<d, 256, 0, stream>>>(mslots, mvalid, table,
                                                       w, sw, tbits);
  }
  distinct_owner_apply<<<grid, 256, 0, stream>>>(x, keep1, table, keep, m,
                                                 shard_len, d, tbits, seed,
                                                 fmode, lane0);
  return cudaGetLastError();
}

// The retired apply (a scan of the lower shards' columns by each survivor),
// for holding the lowest-owner apply against it; launched by no entry point
// of the package.
extern "C" int distinct_apply_scan(const uint32_t* x, const uint8_t* keep1,
                                   const uint32_t* mslots,
                                   const uint8_t* mvalid, uint8_t* keep,
                                   long long m, int shard_len, int d, int w,
                                   int sw, uint32_t seed, int fmode, int grid,
                                   cudaStream_t stream) {
  distinct_apply_kernel<<<grid, 256, 0, stream>>>(
      x, keep1, mslots, mvalid, keep, m, shard_len, d, w, sw, seed, fmode);
  return cudaGetLastError();
}

// Workspace of distinct_pass1_batch.
extern "C" size_t distinct_pass1_batch_workspace(int nq, int shards,
                                                 int shard_len, const int* d) {
  if (nq < 1 || nq > ROWPAR_MAX_Q) return 0;
  uint32_t seeds[ROWPAR_MAX_Q] = {};
  return distinct_batch_work(nq, shards, shard_len, d, nullptr, seeds, 0, 0)
      .total;
}

// DISTINCT pass 1 of a wave of nq <= ROWPAR_MAX_Q queries (B = 1): keep
// [nq][m], slots and valid [nq][shards][dcap][wcap], head [nq][shards][dcap]
// (the wrapper zeroes them first). d, w, seed: host arrays of nq, w <= wcap
// <= 32. work holds distinct_pass1_batch_workspace bytes.
extern "C" int distinct_pass1_batch(const uint32_t* x, uint8_t* keep,
                                    uint32_t* slots, uint8_t* valid, int* head,
                                    int nq, int shards, int shard_len,
                                    const int* d, const int* w,
                                    const uint32_t* seed, int dcap, int wcap,
                                    int lru, int fmode, unsigned char* work,
                                    cudaStream_t stream) {
  if (nq < 1 || nq > ROWPAR_MAX_Q || wcap < 1 || wcap > 32)
    return cudaErrorInvalidValue;
  for (int q = 0; q < nq; ++q)
    if (w[q] < 1 || w[q] > wcap || d[q] < 1 || d[q] > dcap)
      return cudaErrorInvalidValue;
  const DistinctBatchWork k =
      distinct_batch_work(nq, shards, shard_len, d, w, seed, dcap, wcap);
  const RowparQ& p = k.plan;
  const long long n = static_cast<long long>(nq) * shards * shard_len;
  uint2* part = reinterpret_cast<uint2*>(work + k.part);
  int* flags = reinterpret_cast<int*>(work + k.flags);
  int* partial = reinterpret_cast<int*>(work + k.partial);
  uint2* walk = reinterpret_cast<uint2*>(work + k.walk);
  int* starts = nullptr;
  cudaError_t err = rowpar_partition_q(x, nullptr, nullptr, p, part, work,
                                       &starts, stream);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(
      min((n + ROWPAR_THREADS - 1) / ROWPAR_THREADS, 132LL * 16));
  distinct_mark_q<<<grid, ROWPAR_THREADS, 0, stream>>>(part, flags, keep, p,
                                                       fmode);
  err = rowpar_scan(flags, n + 1, partial, stream);
  if (err != cudaSuccess) return err;
  distinct_compact<<<grid, ROWPAR_THREADS, 0, stream>>>(
      part, flags, walk, n, shard_len, fmode, 1);
  if (wcap <= 4)
    distinct_walk_q_launch<4>(walk, flags, starts, keep, slots, valid, head,
                              p, lru, stream);
  else if (wcap <= 8)
    distinct_walk_q_launch<8>(walk, flags, starts, keep, slots, valid, head,
                              p, lru, stream);
  else if (wcap <= 16)
    distinct_walk_q_launch<16>(walk, flags, starts, keep, slots, valid, head,
                               p, lru, stream);
  else
    distinct_walk_q_launch<32>(walk, flags, starts, keep, slots, valid, head,
                               p, lru, stream);
  return cudaGetLastError();
}
