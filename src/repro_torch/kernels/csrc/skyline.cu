// SKYLINE pruning (paper Ex. 6) on Hopper: pass 1 and pass 2.
//
// skyline_pass1 replaces two pallas_calls of the JAX package:
//   skyline_prune_kernel        src/repro/kernels/skyline_prune.py:70  (S = 1)
//   skyline_shard_states_kernel src/repro/kernels/parallel.py:357      (S shards)
// and, at B = 1 with the engine's score form, the engine's per-entry scan
// (core.skyline.skyline_prune, src/repro/core/skyline.py:70-100, a
// lax.scan). Each of S switch lanes keeps w stored points (f32[w][D]) and
// their scores (f32[w], descending, NEG = an empty slot, a zero point).
//
// Scores: SUM (left to right) or APH, sum of e + (v/2^e - 1) for v >= 1 and
// -16 below, with e from the exponent bits and 2^e exact; mode picks the
// association, e + (m - 1) for the engine, (e + m) - 1 for the Pallas
// kernel. No log2f / exp2f: the plain version in core/skyline.py computes
// the same bits. An APH coordinate of +inf scores NaN, as XLA's
// inf / exp2(inf) does.
//
// The engine step (B = 1): an entry of score h goes to pos = #(stored
// scores >= h); it is pruned by a dominator stored below pos and inserted
// at pos whenever pos < w. For scores that are neither NaN nor <= NEG this
// keeps one invariant: the store after a prefix holds the first w entries
// of the prefix in the order (score descending, index ascending), so two
// stores merge: the store after A then B is the first w of the stable merge
// of store(A) and B's top-w candidates, A first on ties. An entry of score
// <= NEG never inserts (the empty NEG slots count in its pos, and it is
// tested against their zero points as well). So the lane's chain of 2^25
// dependent steps is not the work's own: the store changes at about a
// hundred entries of the main path's stream, and every other entry only
// reads it. The pass runs in three phases, all of them data-parallel but
// the second:
//   1. sky_summarize, one CTA a chunk of the lane (256 to 16384 entries,
//      about 2048 chunks over all lanes): each score once, the chunk's top-w
//      candidates (point, score) by w rounds of a block arg-max of (ordered
//      score, inverted index) keys, among scores that are neither NaN nor
//      <= NEG, and a flag when the chunk holds a NaN score;
//   2. sky_chain, one warp a lane: walks the chunk summaries in order, 1024
//      a load and 32 a ballot (a chunk whose best candidate does not beat
//      the last stored score leaves the store as it is), merges the others
//      into the running store (each of the 2w items ranks itself against
//      the other list, compared as floats, so -0 and +0 tie and rank by
//      index), and records the store version in force at each chunk's
//      start;
//   3. sky_replay, one CTA a chunk: from its start store, every thread runs
//      the engine step's test on its entry against the current store; a
//      block-wide min finds the first entry with pos < w; the entries
//      before it take their keep, one thread inserts it, and the round
//      repeats from the next entry. A chunk costs chunk / 256 rounds plus
//      one a stored entry.
// A NaN score breaks the invariant (its pos is 0, so it is stored, and no
// later compare counts it). From a lane's first chunk with a NaN flag on,
// phase 2 stops, and that chunk's CTA replays the rest of the lane in order
// by the same round rule, the engine step against the exact store: a NaN
// costs speed, not exactness. So does a stream that inserts at every entry
// (one round an entry).
// What bounds it: the bytes (x is read twice, keep written once), or the
// work's own chain, the inserts of the lane with the most.
//
// B > 1: block semantics as in src/repro/kernels/ref.py. Every keep decision
// of a block reads the pre-block store (keep iff no stored point with score
// > NEG dominates the entry), then w rounds each take the block's best
// remaining score, ties to the lowest index, and sorted-insert it while it
// beats the last stored score; a NaN score is the block's best and spends a
// round without inserting. The same phases 1 and 2 with a chunk of one
// block (NaN keys rank first and their rounds insert nothing), then one
// elementwise keep pass against each block's start store (sky_keep_block):
// no replay.
//
// A resumed pass (B = 1, resume = 1: the streaming fold, core.streaming)
// starts every lane from its carried store, which sky_chain reads into the
// lane's version 0 before any phase writes the outputs; the replay reads
// only versions, and the store goes out at the end as before (in place).
// The merge's invariant holds for any carried store sorted descending with
// no NaN score, as every store an engine step leaves is, and a lane whose
// carried store is not so is replayed in order from its first entry.
//
// skyline_pass1_serial is the B = 1 kernel these phases replaced (one
// thread of a CTA runs the engine step over its lane). No entry point of
// the package launches it; chip_smoke.py holds the phases against it at
// full size.
//
// skyline_apply replaces skyline_apply_kernel (src/repro/kernels/parallel.py:398)
// and is the engine's pass 2: keep iff none of the S*w merged points with
// score > NEG dominates the entry. It runs in two steps:
//   1. sky_compact_flags and sky_compact_order, one warp a merged point
//      (sw * D * sw compares at most, spread over sw warps): keep a set of
//      the merged points that gives the same mask, k points. It drops the slots whose score is not
//      > NEG (NaN scores too), the points with a NaN coordinate (dominates
//      can never hold for them), every point that another valid point
//      dominates, and every point equal to a valid point of a lower index
//      (all coordinates ==, so -0 and +0 are equal); it orders the rest by
//      score, descending, ties to the lowest index, so that a dominator
//      comes early. Why the mask stays the same: on floats with no NaN
//      coordinate, <= and < are transitive and -0, +0 compare equal both
//      ways, so dominance is a strict partial order on the valid points. If
//      a valid y dominates an entry x, follow dominators up from y to a
//      maximal z (the set is finite): z dominates x (z >= y >= x in every
//      dimension, and y > x in one, so z > x there), and z, or the equal
//      point of lowest index that stands for it, is kept.
//   2. sky_apply_compact: the k points go into shared memory as a
//      structure of arrays; each thread takes two consecutive entries (for
//      D = 2 one float4 load), tests both against the points in order,
//      stops when both are dominated, and writes two keep bytes. The grid
//      is sized to the SMs. (Loading two pairs before testing the first was
//      no faster on an H100.)
// What bounds it: the larger of the bytes (the entries read once, the mask
// written once) and the compares the data needs, (m - kept) * D for the
// entries a point dominates early plus kept * k * D for the survivors.
//
// skyline_apply_scan is the apply this replaced: every thread walks all
// S*w merged slots in slot order until its first dominator, empty slots
// included, so an unsorted set and every survivor pay the full walk. No
// entry point of the package launches it; chip_smoke.py holds the new
// apply against it.
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

// Left to right, then + 0 as XLA's reduce from an init of +0 turns a sum
// of -0s into +0 (a reduce of one element is the element).
__device__ __forceinline__ float score_of(const float* x, int D, int mode) {
  float acc = mode == kSum ? x[0] : aph_term(x[0], mode);
  for (int j = 1; j < D; ++j)
    acc = __fadd_rn(acc, mode == kSum ? x[j] : aph_term(x[j], mode));
  return D > 1 ? __fadd_rn(acc, 0.0f) : acc;
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

__global__ void skyline_pass1_serial_kernel(const float* __restrict__ x,
                                            uint8_t* __restrict__ keep,
                                            float* __restrict__ out_pts,
                                            float* __restrict__ out_sc,
                                            int shard_len, int D, int w,
                                            int mode) {
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

// ------------------------------------------- the phases of skyline_pass1

#define SKY_THREADS 256
#define SKY_MIN_CHUNK 256
#define SKY_MAX_CHUNK 16384
#define SKY_TARGET_CHUNKS 2048  // chunks over all lanes at B = 1
#define SKY_NONE 0x7FFFFFFF     // block min of no entry
#define SKY_BATCH 1024          // chunk summaries the chain loads at once

// A store or a candidate list is one record of w * (D + 1) floats: the w
// scores, then the w points.
struct SkyPlan {
  int shards, shard_len, D, w, block;
  int chunk;      // entries a chunk: B, or at B = 1 a power of two
  int nc;         // chunks a lane
  long long rec;  // floats a record
  size_t cand, best, nanf, vers, cver, first, total;  // workspace bytes
};

static inline size_t sky_align(size_t b) { return (b + 255) & ~size_t(255); }

static inline SkyPlan sky_plan(int shards, int shard_len, int D, int w,
                               int block) {
  SkyPlan p;
  p.shards = shards;
  p.shard_len = shard_len;
  p.D = D;
  p.w = w;
  p.block = block;
  int c = block;
  if (block == 1) {
    c = SKY_MIN_CHUNK;
    while (c < SKY_MAX_CHUNK &&
           static_cast<long long>(shards) * ((shard_len + c - 1) / c) >
               SKY_TARGET_CHUNKS)
      c *= 2;
  }
  p.chunk = c;
  p.nc = shard_len > 0 ? (shard_len + c - 1) / c : 1;
  p.rec = static_cast<long long>(w) * (D + 1);
  const long long chunks = static_cast<long long>(shards) * p.nc;
  p.cand = sky_align(chunks * p.rec * sizeof(float));
  p.best = sky_align(chunks * sizeof(float));
  p.nanf = sky_align(chunks * sizeof(int));
  p.vers = sky_align(static_cast<long long>(shards) * (p.nc + 1) * p.rec *
                     sizeof(float));
  p.cver = sky_align(chunks * sizeof(int));
  p.first = sky_align(static_cast<size_t>(shards) * sizeof(int));
  p.total = p.cand + p.best + p.nanf + p.vers + p.cver + p.first;
  return p;
}

static inline size_t sky_summarize_smem(int chunk, int w) {
  return 32 * sizeof(unsigned long long) + 4 * sizeof(int) +
         (static_cast<size_t>(chunk) + w) * sizeof(unsigned);
}

// Block-wide max of one key a thread; two barriers.
__device__ __forceinline__ unsigned long long sky_block_max(
    unsigned long long k, unsigned long long* wk) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, k, off);
    k = o > k ? o : k;
  }
  if ((threadIdx.x & 31) == 0) wk[threadIdx.x >> 5] = k;
  __syncthreads();
  unsigned long long b = 0ull;
  for (int j = 0; j < static_cast<int>(blockDim.x >> 5); ++j)
    b = wk[j] > b ? wk[j] : b;
  __syncthreads();
  return b;
}

// Block-wide min of one int a thread; two barriers.
__device__ __forceinline__ int sky_block_min(int v, int* wmin) {
  v = __reduce_min_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) wmin[threadIdx.x >> 5] = v;
  __syncthreads();
  int b = wmin[0];
  for (int j = 1; j < static_cast<int>(blockDim.x >> 5); ++j)
    b = min(b, wmin[j]);
  __syncthreads();
  return b;
}

// Phase 1: chunk c of lane s. ords[t] is the chunk's entry t as a key: the
// ordered image of its score + 0 (-0 and +0 tie), 0 when it can be no
// candidate (NaN at B = 1, score <= NEG), and at B > 1 0xFFFFFFFF for a
// NaN, the block's best (no other float maps there). Keys are unique with
// 0xFFFFFFFE - (entry index) in the low word, ties going to the lower
// index; no key is ~0, the first round's limit.
__global__ void __launch_bounds__(SKY_THREADS)
    sky_summarize(const float* __restrict__ x, float* __restrict__ cand,
                  float* __restrict__ best, int* __restrict__ nanf,
                  int shard_len, int nc, int chunk, int D, int w, int mode,
                  int per_entry) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* wk = reinterpret_cast<unsigned long long*>(smem);
  int* nan_count = reinterpret_cast<int*>(wk + 32);
  unsigned* ords = reinterpret_cast<unsigned*>(nan_count + 4);
  int* wins = reinterpret_cast<int*>(ords + chunk);  // the candidates, in order
  const long long ci = blockIdx.x;
  const int s = static_cast<int>(ci / nc);
  const int c = static_cast<int>(ci % nc);
  const long long base =
      static_cast<long long>(s) * shard_len + static_cast<long long>(c) * chunk;
  const int n = min(chunk, shard_len - c * chunk);
  const float neg = cheetah_neg_value();
  if (threadIdx.x == 0) *nan_count = 0;
  __syncthreads();
  int nn = 0;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const float h = score_of(x + (base + t) * D, D, mode);
    const bool nan = h != h;
    nn += nan;
    ords[t] = nan ? (per_entry ? 0u : 0xFFFFFFFFu)
                  : h > neg ? cheetah_ordered(__fadd_rn(h, 0.0f)) : 0u;
  }
  if (nn) atomicAdd(nan_count, nn);
  __syncthreads();
  // this thread's largest key below lim (0: none); its entries are t with
  // t % blockDim.x == threadIdx.x
  auto below = [&](unsigned long long lim) {
    unsigned long long b = 0ull;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const unsigned long long k =
          (static_cast<unsigned long long>(ords[t]) << 32) |
          (0xFFFFFFFEu - static_cast<unsigned>(t));
      if (ords[t] != 0u && k < lim && k > b) b = k;
    }
    return b;
  };
  unsigned long long mine = below(~0ull);
  int taken = 0;
  const int rounds = min(w, n);
  for (int r = 0; r < rounds; ++r) {
    const unsigned long long k = sky_block_max(mine, wk);
    if (k == 0ull) break;
    const int win = static_cast<int>(0xFFFFFFFEu - static_cast<unsigned>(k));
    if ((k >> 32) != 0xFFFFFFFFull) {  // a NaN spends its round
      if (threadIdx.x == 0) wins[taken] = win;
      ++taken;
    }
    if (win % static_cast<int>(blockDim.x) == static_cast<int>(threadIdx.x))
      mine = below(k);
  }
  __syncthreads();
  // the record: candidate j's score (computed as above) and point, loaded
  // by thread j all at once; NEG and zero points past the candidates
  float* rsc = cand + ci * w * (D + 1);
  float* rpts = rsc + w;
  for (int j = threadIdx.x; j < w; j += blockDim.x) {
    const float* xw = x + (base + (j < taken ? wins[j] : 0)) * D;
    const float h = j < taken ? score_of(xw, D, mode) : neg;
    rsc[j] = h;
    for (int k = 0; k < D; ++k) rpts[j * D + k] = j < taken ? xw[k] : 0.0f;
    if (j == 0) best[ci] = h;
  }
  if (threadIdx.x == 0) nanf[ci] = per_entry && *nan_count > 0;
}

// The first w of the stable merge of store st and candidates cd (records,
// both sorted descending, the store first on ties) into nx, by one warp:
// each item ranks itself against the other list.
__device__ __forceinline__ void sky_merge(const float* st, const float* cd,
                                          float* nx, int w, int D, int lane) {
  for (int t = lane; t < 2 * w; t += 32) {
    const bool stored = t < w;
    const int i = stored ? t : t - w;
    const float* from = stored ? st : cd;
    const float h = from[i];
    int rank = i;
    if (stored)
      for (int j = 0; j < w; ++j) rank += cd[j] > h;
    else
      for (int j = 0; j < w; ++j) rank += st[j] >= h;
    if (rank < w) {
      nx[rank] = h;
      for (int k = 0; k < D; ++k) nx[w + rank * D + k] = from[w + i * D + k];
    }
  }
}

// Phase 2: one warp a lane. vers gets the lane's store versions (version 0
// the start store: empty, or with resume the carried store the outputs
// hold, read here before any phase writes them), cver each chunk's start
// version, up to and including the lane's first chunk with a NaN flag
// (first_nan; nc when none). Without a NaN the last version is the lane's
// final store, written out here. A carried store that holds a NaN score or
// is not sorted descending breaks the merge's invariant: the lane is then
// replayed in order from its first chunk (first_nan = 0).
__global__ void sky_chain(const float* __restrict__ cand,
                          const float* __restrict__ best,
                          const int* __restrict__ nanf,
                          float* __restrict__ vers, int* __restrict__ cver,
                          int* __restrict__ first_nan,
                          float* __restrict__ out_pts,
                          float* __restrict__ out_sc, int nc, int D, int w,
                          int resume) {
  extern __shared__ __align__(16) float buf[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int rec = w * (D + 1);
  const float neg = cheetah_neg_value();
  float* st = buf;
  float* nx = buf + rec;
  float* cd = buf + 2 * rec;
  for (int i = lane; i < rec; i += 32)
    st[i] = resume ? (i < w ? out_sc[static_cast<long long>(s) * w + i]
                            : out_pts[static_cast<long long>(s) * w * D + i - w])
                   : (i < w ? neg : 0.0f);
  __syncwarp();
  float* vs = vers + static_cast<long long>(s) * (nc + 1) * rec;
  for (int i = lane; i < rec; i += 32) vs[i] = st[i];
  const long long cb = static_cast<long long>(s) * nc;
  int nv = 0;
  int nan_at = nc;
  if (resume) {
    bool bad = false;
    for (int i = lane; i < w; i += 32)
      bad |= st[i] != st[i] || (i + 1 < w && st[i] < st[i + 1]);
    if (__any_sync(0xFFFFFFFFu, bad)) {
      nan_at = 0;
      if (lane == 0) cver[cb] = 0;
    }
  }
  // SKY_BATCH chunk summaries a load, then walked 32 chunks a ballot
  __shared__ float sb[SKY_BATCH];
  __shared__ int sn[SKY_BATCH];
  for (int b0 = 0; b0 < nc && nan_at == nc; b0 += SKY_BATCH) {
    __syncwarp();
    for (int i = lane; i < SKY_BATCH; i += 32) {
      const bool in = b0 + i < nc;
      sb[i] = in ? best[cb + b0 + i] : neg;
      sn[i] = in ? nanf[cb + b0 + i] : 0;
    }
    __syncwarp();
    // a batch in which no chunk beats the last stored score (the common
    // case) keeps the store: one vote
    bool any = false;
    for (int i = lane; i < SKY_BATCH; i += 32)
      any |= b0 + i < nc && (sn[i] || sb[i] > st[w - 1]);
    if (!__any_sync(0xFFFFFFFFu, any)) {
      for (int i = lane; i < SKY_BATCH && b0 + i < nc; i += 32)
        cver[cb + b0 + i] = nv;
      continue;
    }
    for (int c0 = b0; c0 < min(nc, b0 + SKY_BATCH) && nan_at == nc; c0 += 32) {
      const int c = c0 + lane;
      const bool in = c < nc;
      const float bst = sb[c - b0];
      const int nf = sn[c - b0];
      for (int done = 0;;) {
        const bool open = in && lane >= done;
        const unsigned go =
            __ballot_sync(0xFFFFFFFFu, open && (nf || bst > st[w - 1]));
        const int first = go ? __ffs(go) - 1 : 32;
        if (open && lane <= first) cver[cb + c] = nv;
        if (first == 32) break;
        if (__shfl_sync(0xFFFFFFFFu, nf, first)) {
          nan_at = c0 + first;
          break;
        }
        const float* src = cand + (cb + c0 + first) * rec;
        for (int i = lane; i < rec; i += 32) cd[i] = src[i];
        __syncwarp();
        sky_merge(st, cd, nx, w, D, lane);
        __syncwarp();
        float* t = st;
        st = nx;
        nx = t;
        ++nv;
        for (int i = lane; i < rec; i += 32)
          vs[static_cast<long long>(nv) * rec + i] = st[i];
        done = first + 1;
      }
    }
  }
  if (lane == 0) first_nan[s] = nan_at;
  if (nan_at == nc) {
    for (int i = lane; i < w; i += 32) out_sc[static_cast<long long>(s) * w + i] = st[i];
    for (int i = lane; i < w * D; i += 32)
      out_pts[static_cast<long long>(s) * w * D + i] = st[w + i];
  }
}

// Insert point p with score h at pos (the engine step: the slots after pos
// move up one, the last falls out).
__device__ __forceinline__ void sky_insert_at(float* sc, float* pts, int w,
                                              int D, const float* p, float h,
                                              int pos) {
  for (int j = w - 1; j > pos; --j) {
    sc[j] = sc[j - 1];
    for (int k = 0; k < D; ++k) pts[j * D + k] = pts[(j - 1) * D + k];
  }
  sc[pos] = h;
  for (int k = 0; k < D; ++k) pts[pos * D + k] = p[k];
}

// The engine step over the lane's entries [lo, hi) from the store st (a
// record in shared memory), 256 entries a round: every open entry tests
// itself against the current store, the first with pos < w is inserted
// after the entries before it take their keep, and the round goes on from
// the entry after it.
__device__ void sky_replay_range(const float* __restrict__ x,
                                 uint8_t* __restrict__ keep, float* st,
                                 int* wmin, long long base, int lo, int hi,
                                 int D, int w, int mode) {
  float* sc = st;
  float* pts = st + w;
  for (int t0 = lo; t0 < hi; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool in = t < hi;
    const float* xt = x + (base + (in ? t : lo)) * D;
    const float h = in ? score_of(xt, D, mode) : 0.0f;
    for (int from = t0;;) {
      const bool open = in && t >= from;
      int pos = w;
      bool dom = false;
      if (open) {
        pos = 0;
        for (int j = 0; j < w; ++j) pos += h <= sc[j];
        for (int j = 0; j < pos && !dom; ++j) dom = dominates(pts + j * D, xt, D);
      }
      const int first = sky_block_min(open && pos < w ? t : SKY_NONE, wmin);
      if (open && t <= first) keep[base + t] = !dom;
      if (first == SKY_NONE) break;
      if (t == first) sky_insert_at(sc, pts, w, D, xt, h, pos);
      __syncthreads();
      from = first + 1;
    }
  }
}

// Phase 3 at B = 1: one CTA a chunk, from its start store. The CTA of a
// lane's first chunk with a NaN score replays the rest of the lane in order
// and writes the lane's final store; the CTAs of later chunks do nothing.
__global__ void __launch_bounds__(SKY_THREADS)
    sky_replay(const float* __restrict__ x, uint8_t* __restrict__ keep,
               const float* __restrict__ vers, const int* __restrict__ cver,
               const int* __restrict__ first_nan, float* __restrict__ out_pts,
               float* __restrict__ out_sc, int shard_len, int nc, int chunk,
               int D, int w, int mode) {
  extern __shared__ __align__(16) float sm[];
  int* wmin = reinterpret_cast<int*>(sm);
  float* st = sm + 32;
  const int s = blockIdx.x / nc;
  const int c = blockIdx.x % nc;
  const int f = first_nan[s];
  if (c > f) return;
  const int rec = w * (D + 1);
  const float* src =
      vers + (static_cast<long long>(s) * (nc + 1) + cver[static_cast<long long>(s) * nc + c]) * rec;
  for (int i = threadIdx.x; i < rec; i += blockDim.x) st[i] = src[i];
  __syncthreads();
  const long long base = static_cast<long long>(s) * shard_len;
  const int lo = c * chunk;
  const int hi = c == f ? shard_len : min(shard_len, lo + chunk);
  sky_replay_range(x, keep, st, wmin, base, lo, hi, D, w, mode);
  if (c == f) {
    __syncthreads();
    for (int i = threadIdx.x; i < w; i += blockDim.x)
      out_sc[static_cast<long long>(s) * w + i] = st[i];
    for (int i = threadIdx.x; i < w * D; i += blockDim.x)
      out_pts[static_cast<long long>(s) * w * D + i] = st[w + i];
  }
}

// Phase 3 at B > 1: keep iff no stored point with score > NEG of the
// block's start store dominates the entry.
__global__ void sky_keep_block(const float* __restrict__ x,
                               uint8_t* __restrict__ keep,
                               const float* __restrict__ vers,
                               const int* __restrict__ cver, long long m,
                               int shard_len, int nc, int block, int D,
                               int w) {
  const long long rec = static_cast<long long>(w) * (D + 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const long long s = i / shard_len;
    const int c = static_cast<int>((i - s * shard_len) / block);
    const float* st = vers + (s * (nc + 1) + cver[s * nc + c]) * rec;
    keep[i] = !dominated(st + w, st, w, D, x + i * D);
  }
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

#define SKY_COMPACT_WARPS 8  // points a CTA of the compaction takes

// The compaction's workspace: the count k (16 bytes), the keep flags
// int[sw], then the kept points as f32[D][sw] and their scores f32[sw].
struct SkyCompactWork {
  int* count;
  int* flag;
  float* pts;
  float* scs;
};

SkyCompactWork sky_compact_work(unsigned char* work, int sw, int D) {
  SkyCompactWork w;
  w.count = reinterpret_cast<int*>(work);
  w.flag = reinterpret_cast<int*>(work + 16);
  w.pts = reinterpret_cast<float*>(w.flag + sw);
  w.scs = w.pts + static_cast<size_t>(D) * sw;
  return w;
}

size_t sky_compact_bytes(int sw, int D) {
  return 16 + static_cast<size_t>(sw) * (1 + D + 1) * 4;
}

// Step 1a of the apply (see the header): one warp a merged point j, its
// lanes over the other points i in strides of 32. flag[j] = j is valid and
// no valid i dominates it or equals it at a lower index.
__global__ void __launch_bounds__(SKY_COMPACT_WARPS * 32)
    sky_compact_flags(const float* __restrict__ mp,
                      const float* __restrict__ ms, int sw, int D,
                      int* __restrict__ flag) {
  const int j = blockIdx.x * SKY_COMPACT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= sw) return;  // whole warps
  const float neg = cheetah_neg_value();
  const float* pj = mp + static_cast<size_t>(j) * D;
  bool ok = ms[j] > neg;
  for (int d = 0; d < D; ++d) ok = ok && !isnan(pj[d]);
  bool beaten = false;
  if (ok) {
#pragma unroll 4
    for (int i = lane; i < sw; i += 32) {
      if (i == j || !(ms[i] > neg)) continue;
      const float* pi = mp + static_cast<size_t>(i) * D;
      bool valid = true, ge = true, gt = false, eq = true;
      for (int d = 0; d < D; ++d) {
        const float a = pi[d], b = pj[d];
        valid &= !isnan(a);
        ge &= b <= a;
        gt |= b < a;
        eq &= a == b;
      }
      beaten |= valid && ((ge && gt) || (eq && i < j));
    }
  }
  beaten = __any_sync(0xFFFFFFFFu, beaten);
  if (lane == 0) flag[j] = ok && !beaten;
}

// Step 1b: one warp a flagged point j: its rank among the flagged points
// by score descending, ties to the lowest index, is its slot in the
// compacted set; the warp of point 0 also writes the count k.
__global__ void __launch_bounds__(SKY_COMPACT_WARPS * 32)
    sky_compact_order(const float* __restrict__ mp,
                      const float* __restrict__ ms, int sw, int D,
                      const int* __restrict__ flag, int* __restrict__ count,
                      float* __restrict__ pts, float* __restrict__ scs) {
  const int j = blockIdx.x * SKY_COMPACT_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= sw || !(flag[j] || j == 0)) return;  // whole warps
  const float sj = ms[j];
  int rank = 0, total = 0;
  for (int i = lane; i < sw; i += 32) {
    const bool f = flag[i] != 0;
    rank += f && (ms[i] > sj || (ms[i] == sj && i < j));
    total += f;
  }
  rank = __reduce_add_sync(0xFFFFFFFFu, rank);
  total = __reduce_add_sync(0xFFFFFFFFu, total);
  if (j == 0 && lane == 0) *count = total;
  if (!flag[j]) return;
  for (int d = lane; d < D; d += 32)
    pts[static_cast<size_t>(d) * sw + rank] = mp[static_cast<size_t>(j) * D + d];
  if (lane == 0) scs[rank] = sj;
}

template <int D>
__device__ __forceinline__ bool sky_dom(const float* p, const float* x) {
  bool ge = true, gt = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ge &= x[d] <= p[d];
    gt |= x[d] < p[d];
  }
  return ge && gt;
}

// Step 2 of the apply (see the header): ``pts`` holds the k kept points as
// f32[D][ld]; staged in shared memory as f32[D][k] when ``staged``. ``vec``:
// x lies on 16 bytes and keep on 2, so that D = 2 reads a pair of entries
// with one float4 and writes their keep bytes with one uchar2 (a view that
// starts at an odd entry takes the scalar loads and stores).
template <int D>
__global__ void sky_apply_compact(const float* __restrict__ x,
                                  const float* __restrict__ pts,
                                  const int* __restrict__ count, int ld,
                                  uint8_t* __restrict__ keep, long long m,
                                  int staged, int vec) {
  extern __shared__ __align__(16) float sky_pts[];
  const int k = *count;
  const float* P = pts;
  int stride_d = ld;
  if (staged) {
    for (int i = threadIdx.x; i < D * k; i += blockDim.x)
      sky_pts[i] = pts[static_cast<size_t>(i / k) * ld + i % k];
    __syncthreads();
    P = sky_pts;
    stride_d = k;
  }
  const long long pairs = (m + 1) / 2;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < pairs; q += step) {
    const long long i0 = 2 * q;
    const bool two = i0 + 1 < m;
    float a[D], b[D];
    if (D == 2 && two && vec) {
      const float4 v = reinterpret_cast<const float4*>(x)[q];
      a[0] = v.x;
      a[D - 1] = v.y;
      b[0] = v.z;
      b[D - 1] = v.w;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        a[d] = x[i0 * D + d];
        b[d] = two ? x[(i0 + 1) * D + d] : 0.0f;
      }
    }
    bool da = false, db = !two;
    for (int j = 0; j < k && !(da && db); ++j) {
      float p[D];
#pragma unroll
      for (int d = 0; d < D; ++d) p[d] = P[static_cast<size_t>(d) * stride_d + j];
      da = da || sky_dom<D>(p, a);
      db = db || sky_dom<D>(p, b);
    }
    if (two && vec) {
      reinterpret_cast<uchar2*>(keep)[q] = make_uchar2(!da, !db);
    } else {
      keep[i0] = !da;
      if (two) keep[i0 + 1] = !db;
    }
  }
}

cudaError_t compact_launch(const float* mp, const float* ms, int sw, int D,
                           SkyCompactWork w, cudaStream_t stream) {
  const unsigned grid = (sw + SKY_COMPACT_WARPS - 1) / SKY_COMPACT_WARPS;
  sky_compact_flags<<<grid, SKY_COMPACT_WARPS * 32, 0, stream>>>(mp, ms, sw,
                                                                 D, w.flag);
  sky_compact_order<<<grid, SKY_COMPACT_WARPS * 32, 0, stream>>>(
      mp, ms, sw, D, w.flag, w.count, w.pts, w.scs);
  return cudaGetLastError();
}

template <int D>
cudaError_t compact_apply_launch(const float* x, const float* mp,
                                 const float* ms, uint8_t* keep, long long m,
                                 int sw, int grid, unsigned char* work,
                                 cudaStream_t stream) {
  const SkyCompactWork w = sky_compact_work(work, sw, D);
  cudaError_t err = compact_launch(mp, ms, sw, D, w, stream);
  if (err != cudaSuccess) return err;
  const size_t bytes = static_cast<size_t>(sw) * D * sizeof(float);
  const int staged = bytes <= CHEETAH_MAX_SMEM;
  const size_t smem = staged ? bytes : 0;
  err = cheetah_launch_prep(
      reinterpret_cast<const void*>(sky_apply_compact<D>), smem);
  if (err != cudaSuccess) return err;
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(keep) % 2 == 0;
  sky_apply_compact<D><<<grid, 256, smem, stream>>>(x, w.pts, w.count, sw,
                                                    keep, m, staged, vec);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of the largest phase: the summary's or the chain's (the
// replay's 32 ints and one record are less than either).
extern "C" size_t skyline_pass1_smem(int D, int w, int block) {
  const size_t rec = static_cast<size_t>(w) * (D + 1) * sizeof(float);
  const size_t sum = sky_summarize_smem(block == 1 ? SKY_MAX_CHUNK : block, w);
  const size_t chain = 3 * rec + SKY_BATCH * (sizeof(float) + sizeof(int));
  return sum > chain ? sum : chain;
}

extern "C" size_t skyline_pass1_workspace(int shards, int shard_len, int D,
                                          int w, int block) {
  return sky_plan(shards, shard_len, D, w, block).total;
}

// resume (B = 1 only, the streaming fold): each lane's chain starts from
// the store out_pts / out_sc hold, which take the final one in place.
extern "C" int skyline_pass1(const float* x, uint8_t* keep, float* out_pts,
                             float* out_sc, int shards, int shard_len, int D,
                             int w, int block, int mode, unsigned char* work,
                             int resume, cudaStream_t stream) {
  if (resume && block != 1) return cudaErrorInvalidValue;
  const SkyPlan p = sky_plan(shards, shard_len, D, w, block);
  float* cand = reinterpret_cast<float*>(work);
  float* best = reinterpret_cast<float*>(work + p.cand);
  int* nanf = reinterpret_cast<int*>(work + p.cand + p.best);
  float* vers = reinterpret_cast<float*>(work + p.cand + p.best + p.nanf);
  int* cver = reinterpret_cast<int*>(work + p.cand + p.best + p.nanf + p.vers);
  int* first = reinterpret_cast<int*>(work + p.cand + p.best + p.nanf +
                                      p.vers + p.cver);
  const unsigned chunks = static_cast<unsigned>(shards) * p.nc;
  const size_t rec = static_cast<size_t>(p.rec) * sizeof(float);
  const size_t s1 = sky_summarize_smem(p.chunk, w);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(sky_summarize), s1);
  if (err != cudaSuccess) return err;
  sky_summarize<<<chunks, SKY_THREADS, s1, stream>>>(
      x, cand, best, nanf, shard_len, p.nc, p.chunk, D, w, mode, block == 1);
  err = cheetah_launch_prep(reinterpret_cast<const void*>(sky_chain), 3 * rec);
  if (err != cudaSuccess) return err;
  sky_chain<<<shards, 32, 3 * rec, stream>>>(cand, best, nanf, vers, cver,
                                             first, out_pts, out_sc, p.nc, D,
                                             w, resume);
  if (block == 1) {
    const size_t s3 = 32 * sizeof(int) + rec;
    err = cheetah_launch_prep(reinterpret_cast<const void*>(sky_replay), s3);
    if (err != cudaSuccess) return err;
    sky_replay<<<chunks, SKY_THREADS, s3, stream>>>(
        x, keep, vers, cver, first, out_pts, out_sc, shard_len, p.nc,
        p.chunk, D, w, mode);
  } else {
    const long long m = static_cast<long long>(shards) * shard_len;
    const unsigned grid = static_cast<unsigned>(min((m + 255) / 256, 132LL * 16));
    sky_keep_block<<<grid, 256, 0, stream>>>(x, keep, vers, cver, m,
                                             shard_len, p.nc, block, D, w);
  }
  return cudaGetLastError();
}

// The retired one-thread engine scan (B = 1), for holding the phases
// against it; launched by no entry point of the package.
extern "C" int skyline_pass1_serial(const float* x, uint8_t* keep,
                                    float* out_pts, float* out_sc, int shards,
                                    int shard_len, int D, int w, int mode,
                                    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(w) * (D + 1) * sizeof(float) +
                      CHEETAH_STAGE * ((D + 1) * sizeof(float) + 1);
  cudaError_t err = cheetah_launch_prep(
      reinterpret_cast<const void*>(skyline_pass1_serial_kernel), smem);
  if (err != cudaSuccess) return err;
  skyline_pass1_serial_kernel<<<shards, CHEETAH_STAGE, smem, stream>>>(
      x, keep, out_pts, out_sc, shard_len, D, w, mode);
  return cudaGetLastError();
}

extern "C" size_t skyline_apply_workspace(int sw, int D) {
  return sky_compact_bytes(sw, D);
}

extern "C" int skyline_apply(const float* x, const float* mp, const float* ms,
                             uint8_t* keep, long long m, int D, int sw,
                             int grid, unsigned char* work,
                             cudaStream_t stream) {
#define SKY_CASE(N)                                                         \
  case N:                                                                   \
    return compact_apply_launch<N>(x, mp, ms, keep, m, sw, grid, work, stream)
  switch (D) {
    SKY_CASE(1);
    SKY_CASE(2);
    SKY_CASE(3);
    SKY_CASE(4);
    SKY_CASE(5);
    SKY_CASE(6);
    SKY_CASE(7);
    SKY_CASE(8);
    default: return cudaErrorInvalidValue;
  }
#undef SKY_CASE
}

// The retired apply (the slot-order scan), for holding the compacted apply
// against it; launched by no entry point of the package.
extern "C" int skyline_apply_scan(const float* x, const float* mp,
                                  const float* ms, uint8_t* keep, long long m,
                                  int D, int sw, int grid,
                                  cudaStream_t stream) {
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
