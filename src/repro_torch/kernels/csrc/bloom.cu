// Bloom filter (paper Ex. 4, JOIN) on Hopper: build and query.
//
// bloom_build replaces bloom_build_kernel (src/repro/kernels/bloom_filter.py:39)
// and builds the engine's JOIN filters (core.sketches.bloom_build, an XLA
// scatter in the JAX package). The filter is a packed uint32 bitset (bit i
// is bit i % 32 of word i / 32), not the TPU kernel's f32[nbits] 0/1 vector.
// Every key sets its H probed bits with an atomic OR; OR is idempotent, so
// the build is exact in any order. An optional byte mask drops entries
// (mask= of core.sketches.bloom_build).
//
// What bounds it: the bit sets, not the bytes. JOIN's F_A sets 3 * 2^25
// bits of a 2^24-bit (2 MiB) filter; as global atomics that is 10^8 L2
// atomics, some 40x the time to read the keys. bloom_build holds the
// filter in the shared memory of a thread-block cluster instead: each of
// the cluster's K CTAs (K <= 16; 2 MiB takes 16 slices of 128 KiB) owns
// one contiguous slice of the words, of bloom_cluster_slice(nwords, K)
// words (a multiple of 4). One atomic OR into another CTA's shared memory
// a probe was tried first and was no faster than the L2 atomics, so the
// probes travel in bulk: a CTA bins each round's probes by owning CTA in
// its own shared memory, copies each bin with 16-byte stores into the
// owner's inbox (distributed shared memory), and after a cluster barrier
// each CTA ORs its inbox into its slice with local atomics (see
// bloom_cluster_kernel). What bounds this form is those local atomics, the
// barrier a round and the hashing: 10^8 probes over the 7 clusters of 16
// CTAs that an H100 holds at once. Then each cluster ORs its copy into
// ``words`` with a global atomicOr a non-zero word (coalesced; writing
// each cluster's copy out and ORing the copies in a second launch was
// tried and was no faster). bloom_cluster_plan gives the layout: K, the
// slice, and the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters); the layout lives here alone. The grid
// is that many clusters, but no more than give each cluster a round of
// keys; a launch the card refuses returns its error, and the wrapper
// raises.
//
// bloom_build_global is the kernel the cluster build replaced: each CTA
// ORs into a partial bitset in its shared memory when the filter fits the
// default 48 KB (the ops form: nbits < 2^16, at most 8 KB) and flushes its
// non-zero words with global atomicOr; a larger filter takes global
// atomics directly. The wrapper (kernels/bloom_filter.py, bloom_route)
// takes it for filters of 48 KB or less, for those no cluster of 16 holds,
// and where the keys set fewer probes a filter word (3 on an H100) than
// the cluster build needs to pay for zeroing and flushing its copies.
// Where the cluster build serves, it is a witness only: chip_smoke.py holds
// the cluster build against it at JOIN's two filters.
//
// bloom_query replaces bloom_query_kernel (src/repro/kernels/bloom_filter.py:71):
// per key, the AND over its H probed bits, with an exit at the first zero.
// It is a persistent query (bloom_query_persistent, query.cuh), 8 keys a
// thread a step by 16-byte loads, one vector store of keep bytes a unit of
// 4 keys: a filter of 48 KB or less (the ops form) is staged in each CTA's
// shared memory; a larger one (JOIN's 2 MiB filters) is read from global
// memory, where it stays in L2, each probe's loads issued for all 8 keys
// before any is tested and the next probe only for the keys still alive
// (the staged form takes every probe).
// bloom_query_plan gives the route and the grid. A filter held across a
// 16-CTA cluster's distributed shared memory, as the build holds it, was
// not tried for the query (the build found one atomic a probe into another
// CTA's shared memory no faster than an L2 atomic). bloom_query_grid is the
// grid-stride query it
// replaced, kept for chip_smoke.py's witness. The bytes bound (the keys
// read once, the keep mask written once) is not the one that holds at
// JOIN's keep_a: each live probe reads a random 32-byte L2 sector.
//
// Hash family at run time: family 0 is the Pallas kernels'
// hash_mod(key, nbits, seed + 101 h), family 2 the same on an int32 key in
// the Pallas kernels' signed arithmetic (hash.cuh; its probe of -1,
// BLOOM_NONE, sets nothing and reads as unset), family 1 the engine's
// multi_hash(key, nbits, H, seed) (modulo, no 2^16 cap).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "query.cuh"

namespace cg = cooperative_groups;

#define BLOOM_CLUSTER_THREADS 1024
#define BLOOM_MAX_CLUSTER 16
#define BLOOM_KPT 2    // keys a thread a round
#define BLOOM_MAX_H 4  // hashes the cluster build takes (the probes of a
                       // round are held in registers)

namespace {

#define BLOOM_NONE 0xFFFFFFFFu  // a dropped probe of family 2

__device__ __forceinline__ uint32_t bloom_bit(uint32_t key, int h,
                                              uint32_t nbits, uint32_t seed,
                                              int family) {
  const uint32_t s = seed + 101u * static_cast<uint32_t>(h);
  if (family == 1)
    return static_cast<uint32_t>(
        cheetah_multi_hash(key, nbits, static_cast<uint32_t>(h), seed));
  return static_cast<uint32_t>(family == 2 ? cheetah_hash_mod_i32(key, nbits, s)
                                           : cheetah_hash_mod(key, nbits, s));
}

// Words a CTA of a cluster of K owns: ceil(nwords / K), rounded up to a
// multiple of 4 so that every slice starts on 16 bytes.
static inline int bloom_cluster_slice(int nwords, int K) {
  const int s = (nwords + K - 1) / K;
  return (s + 3) & ~3;
}

// Probes a bin holds a round: the mean (BLOOM_CLUSTER_THREADS * BLOOM_KPT
// * H / K a CTA and owner) and a sixth more, a multiple of 4; the rare
// probe past it goes to its owner directly.
static inline int bloom_cluster_cap(int K, int H) {
  const int mean = (BLOOM_CLUSTER_THREADS * BLOOM_KPT * H + K - 1) / K;
  return (mean + mean / 6 + 3) & ~3;
}

// Shared memory of a CTA of the cluster build: the slice, the bins, the two
// inboxes, the counts and the warps' counters.
static inline size_t bloom_cluster_smem(int slice, int K, int H) {
  return (static_cast<size_t>(slice) + 3 * static_cast<size_t>(K) *
                                           bloom_cluster_cap(K, H) +
          (3 + BLOOM_CLUSTER_THREADS / 32) * static_cast<size_t>(K)) * 4;
}

// The cluster barrier in two halves, so that a CTA can work between its
// arrival and its wait (barrier.cluster, sm_90).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The probes of one round of a thread: its BLOOM_KPT keys' first H hashes
// (H <= BLOOM_MAX_H), each with its owning CTA (-1: none), its place among
// its warp's probes for that owner, and its payload (local word << 5 | bit).
struct BloomProbes {
  int own[BLOOM_KPT * BLOOM_MAX_H];
  int off[BLOOM_KPT * BLOOM_MAX_H];
  uint32_t pay[BLOOM_KPT * BLOOM_MAX_H];
};

// One cluster of K CTAs holds the filter, CTA r the words
// [r * slice, (r + 1) * slice). Cluster q takes the q-th of ``clusters``
// contiguous ranges of the keys, in rounds of BLOOM_KPT keys a thread. A
// round: (1) each probe counts itself among its warp's probes for its
// owning CTA (a shared atomic on a row of counters of the warp's own); a
// scan over the warps' rows gives each warp its offsets, and each probe is
// stored at its place in the local bin of its owner; (2) each bin is
// copied with 16-byte stores into the owner's inbox for this CTA, with its
// count; (3) a cluster barrier, whose wait the next round's hashing
// overlaps; (4) each CTA ORs the probes of its inbox into its slice with
// local atomics. The inboxes are double-buffered, so one barrier a round
// suffices: a CTA writes an inbox again only two rounds later, after the
// owner has passed the barrier that follows its reading it; after the last
// round no CTA touches another's shared memory. A probe that finds its bin
// full (more than ``cap`` a round) is ORed into the owner's slice directly.
// Shared memory: the slice, the bins [K][cap], the inboxes [2][K][cap], the
// bin totals [K], the inbox counts [2][K] and the warps' counters [32][K].
__device__ __forceinline__ void bloom_hash_round(
    const uint32_t* __restrict__ keys, const uint8_t* __restrict__ mask,
    long long i0, long long hi, uint32_t nbits, int H, uint32_t seed,
    int family, int slice, bool slice_p2, int slice_sh, bool nbits_p2,
    int* wrow, BloomProbes& p) {
#pragma unroll
  for (int k = 0; k < BLOOM_KPT; ++k) {
    const long long i = i0 + static_cast<long long>(k) * blockDim.x;
    const bool in = i < hi && (mask == nullptr || mask[i] != 0);
    const uint32_t key = in ? __ldg(keys + i) : 0u;
#pragma unroll
    for (int h = 0; h < BLOOM_MAX_H; ++h) {
      const int j = k * BLOOM_MAX_H + h;
      p.own[j] = -1;
      if (!in || h >= H) continue;
      const uint32_t b =
          nbits_p2 ? cheetah_mix32(key, static_cast<uint32_t>(h) *
                                            0x9E3779B9u + seed) &
                         (nbits - 1u)
                   : bloom_bit(key, h, nbits, seed, family);
      if (b == BLOOM_NONE) continue;
      const uint32_t word = b >> 5;
      const uint32_t r =
          slice_p2 ? word >> slice_sh : word / static_cast<uint32_t>(slice);
      p.own[j] = static_cast<int>(r);
      p.off[j] = atomicAdd(wrow + r, 1);
      p.pay[j] = ((word - r * static_cast<uint32_t>(slice)) << 5) | (b & 31u);
    }
  }
}

__global__ void __launch_bounds__(BLOOM_CLUSTER_THREADS, 1)
    bloom_cluster_kernel(const uint32_t* __restrict__ keys,
                         const uint8_t* __restrict__ mask,
                         uint32_t* __restrict__ words, long long m,
                         uint32_t nbits, int H, uint32_t seed, int family,
                         int slice, int cap, int clusters) {
  extern __shared__ __align__(16) uint32_t part[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  uint32_t* bins = part + slice;
  uint32_t* inbox = bins + K * cap;
  int* bincount = reinterpret_cast<int*>(inbox + 2 * K * cap);
  int* incount = bincount + K;
  int* wcnt = incount + 2 * K;  // [warp][K]: counts, then offsets
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < slice; i += blockDim.x) part[i] = 0u;
  for (int i = tid; i < nwarps * K; i += blockDim.x) wcnt[i] = 0;
  // slice and nbits are powers of two for the JOIN filter: shift and mask
  const bool slice_p2 = (slice & (slice - 1)) == 0;
  const int slice_sh = __ffs(slice) - 1;
  const bool nbits_p2 = family == 1 && (nbits & (nbits - 1)) == 0;
  const long long q = blockIdx.x / K;
  const long long lo = m * q / clusters;
  const long long hi = m * (q + 1) / clusters;
  const long long per_round =
      static_cast<long long>(K) * blockDim.x * BLOOM_KPT;
  const long long rounds = (hi - lo + per_round - 1) / per_round;
  const long long mine = lo + static_cast<long long>(rank) * blockDim.x *
                                  BLOOM_KPT + tid;
  cluster.sync();
  BloomProbes p;
  if (rounds > 0)
    bloom_hash_round(keys, mask, mine, hi, nbits, H, seed, family, slice,
                     slice_p2, slice_sh, nbits_p2, wcnt + warp * K, p);
  int buf = 0;
  for (long long rd = 0; rd < rounds; ++rd) {
    __syncthreads();
    // warp r turns column r of the counters into offsets, in warp order
    for (int r = warp; r < K; r += nwarps) {
      const int c = lane < nwarps ? wcnt[lane * K + r] : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (lane < nwarps) wcnt[lane * K + r] = incl - c;
      if (lane == 31) bincount[r] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BLOOM_KPT * BLOOM_MAX_H; ++j) {
      if (p.own[j] < 0) continue;
      const int pos = wcnt[warp * K + p.own[j]] + p.off[j];
      if (pos < cap)
        bins[p.own[j] * cap + pos] = p.pay[j];
      else
        atomicOr(cluster.map_shared_rank(part, p.own[j]) + (p.pay[j] >> 5),
                 1u << (p.pay[j] & 31u));
    }
    __syncthreads();
    for (int r = warp; r < K; r += nwarps) {
      const int n = min(bincount[r], cap);
      uint4* dst = reinterpret_cast<uint4*>(cluster.map_shared_rank(
          inbox + (buf * K + rank) * cap, r));
      const uint4* src = reinterpret_cast<const uint4*>(bins + r * cap);
      for (int v = lane; v < (n + 3) / 4; v += 32) dst[v] = src[v];
      if (lane == 0)
        *cluster.map_shared_rank(incount + buf * K + rank, r) = n;
    }
    cluster_arrive();
    // the next round's hashing, while the cluster gathers at the barrier
    for (int v = tid; v < nwarps * K; v += blockDim.x) wcnt[v] = 0;
    __syncthreads();
    if (rd + 1 < rounds)
      bloom_hash_round(keys, mask, mine + (rd + 1) * per_round, hi, nbits, H,
                       seed, family, slice, slice_p2, slice_sh, nbits_p2,
                       wcnt + warp * K, p);
    cluster_wait();
    // K sources, blockDim.x / K threads each
    const int per = blockDim.x / K;
    const int s = tid / per;
    if (s < K) {
      const int n = incount[buf * K + s];
      const uint32_t* box = inbox + (buf * K + s) * cap;
      for (int v = tid - s * per; v < n; v += per) {
        const uint32_t pb = box[v];
        atomicOr(part + (pb >> 5), 1u << (pb & 31u));
      }
    }
    buf ^= 1;
  }
  __syncthreads();
  // this cluster's copy, ORed into ``words`` a non-zero word at a time
  const int nwords = static_cast<int>((nbits + 31u) / 32u);
  const int base = rank * slice;
  const int own = nwords - base < slice ? nwords - base : slice;
  for (int i = tid; i < own; i += blockDim.x)
    if (part[i]) atomicOr(words + base + i, part[i]);
}

__global__ void bloom_build_kernel(const uint32_t* __restrict__ keys,
                                   const uint8_t* __restrict__ mask,
                                   uint32_t* __restrict__ words, long long m,
                                   uint32_t nbits, int H, uint32_t seed,
                                   int family, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* part = reinterpret_cast<uint32_t*>(smem);
  const int nwords = static_cast<int>((nbits + 31u) / 32u);
  uint32_t* dst = staged ? part : words;
  if (staged) {
    for (int i = threadIdx.x; i < nwords; i += blockDim.x) part[i] = 0u;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    if (mask && !mask[i]) continue;
    const uint32_t key = keys[i];
    for (int h = 0; h < H; ++h) {
      const uint32_t b = bloom_bit(key, h, nbits, seed, family);
      if (b != BLOOM_NONE) atomicOr(dst + (b >> 5), 1u << (b & 31u));
    }
  }
  if (staged) {
    __syncthreads();
    for (int i = threadIdx.x; i < nwords; i += blockDim.x)
      if (part[i]) atomicOr(words + i, part[i]);
  }
}

__global__ void bloom_query_kernel(const uint32_t* __restrict__ words,
                                   const uint32_t* __restrict__ keys,
                                   uint8_t* __restrict__ keep, long long m,
                                   uint32_t nbits, int H, uint32_t seed,
                                   int family) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const uint32_t key = keys[i];
    uint8_t ok = 1;
    for (int h = 0; h < H && ok; ++h) {
      const uint32_t b = bloom_bit(key, h, nbits, seed, family);
      ok = b != BLOOM_NONE && ((__ldg(words + (b >> 5)) >> (b & 31u)) & 1u);
    }
    keep[i] = ok;
  }
}

// The persistent query (see the header; the scaffolding is query.cuh's):
// grid of query_ctas CTAs of QUERY_THREADS threads, 8 keys a thread a step.
// kStaged: the words are copied into each CTA's shared memory first (a
// filter of BLOOM_QUERY_STAGED_BYTES or less, the ops form); else they are
// read from global memory, where a 2 MiB JOIN filter stays in L2. Either
// way a thread hashes a probe of its 8 keys and issues all 8 word loads
// before it tests any. From global memory the next probe loads only the
// words of the keys still alive, so a key stops at its first unset bit and
// a thread once all 8 have; staged, every probe of every key is taken,
// with no branch (a dead key stays dead). H > 0 unrolls the
// probes (the main path's 3); 0 takes ``hashes`` at run time. kPow2: an
// nbits that is a power of two (query.cuh).
//
// ``nonfinite`` (ops.bloom_query; null otherwise) holds what the f32 bits
// the words were packed from imply for the Pallas query's one-hot reads:
// the count of their non-finite entries (2: two or more) and the first
// one's position. With none, the query is the one above. With one, set in
// the words (it was +inf), a probe of any other bit reads NaN, so a key is
// kept only when every probe hits that bit; otherwise no key is kept.
#define BLOOM_QUERY_STAGED_BYTES (48 * 1024)
#define BQ_KEYS (4 * QUERY_UNITS)  // keys a thread a step

template <bool kStaged>
__device__ __forceinline__ uint32_t bq_word(const uint32_t* w, uint32_t i) {
  if constexpr (kStaged)
    return w[i];
  else
    return __ldg(w + i);
}

// Probe h of N keys: bit 0 of acc[j] is whether key j is still alive, and
// the probe ANDs it with its bit, the word shifted right by the bit's place.
// It hashes every key and loads the word of every key alive (a predicated
// load, no branch a key; staged, every key's: a dead key stays dead), all
// before it tests any. Only family 2 without a power of two can probe -1,
// which reads as unset.
template <int FAM, bool kPow2, bool kStaged, int N>
__device__ __forceinline__ void bq_probe(const uint32_t (&k)[N],
                                         uint32_t (&acc)[N],
                                         const uint32_t* w, int h,
                                         uint32_t seed, const QueryHash& q) {
  constexpr bool kNone = FAM == 2 && !kPow2;
  uint32_t b[N], v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    b[j] = query_column<FAM, kPow2>(k[j], query_seed<FAM>(seed, h), q);
    const bool load =
        (kStaged || (acc[j] & 1u)) && (!kNone || b[j] != BLOOM_NONE);
    v[j] = load ? bq_word<kStaged>(w, b[j] >> 5) : 0u;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] &= v[j] >> (b[j] & 31u);
}

// The keys of N alive (bit j of alive) after all probes. The global form
// stops once none is, for that saves L2 sectors; the staged form probes on.
template <int FAM, int H, bool kPow2, bool kStaged, int N>
__device__ __forceinline__ uint32_t bq_alive(const uint32_t (&k)[N],
                                             uint32_t alive,
                                             const uint32_t* w, int hashes,
                                             uint32_t seed,
                                             const QueryHash& q) {
  uint32_t acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = (alive >> j) & 1u;
  auto any = [&]() {
    uint32_t a = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) a |= acc[j];
    return (a & 1u) != 0;
  };
  if constexpr (H > 0) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      if (kStaged || any())
        bq_probe<FAM, kPow2, kStaged, N>(k, acc, w, h, seed, q);
  } else {
    for (int h = 0; h < hashes && (kStaged || any()); ++h)
      bq_probe<FAM, kPow2, kStaged, N>(k, acc, w, h, seed, q);
  }
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) out |= (acc[j] & 1u) << j;
  return out;
}

// The same under a non-finite bit (count, at pos, set or not in the words).
template <int FAM, int H, bool kPow2, int N>
__device__ __forceinline__ uint32_t bq_alive_nonfinite(
    const uint32_t (&k)[N], uint32_t alive, int hashes, uint32_t seed,
    const QueryHash& q, int count, uint32_t pos, bool pos_set) {
  if (count != 1 || !pos_set) return 0u;
  const int HH = H > 0 ? H : hashes;
  for (int h = 0; h < HH; ++h) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (query_column<FAM, kPow2>(k[j], query_seed<FAM>(seed, h), q) != pos)
        alive &= ~(1u << j);
  }
  return alive;
}

template <int FAM, int H, bool kStaged, bool kPow2>
__global__ void __launch_bounds__(QUERY_THREADS)
    bloom_query_persistent(const uint32_t* __restrict__ words,
                           const uint32_t* __restrict__ keys,
                           uint8_t* __restrict__ keep, long long m,
                           int nwords, int hashes, uint32_t seed,
                           QueryHash q, const int* __restrict__ nonfinite,
                           int vec_out) {
  extern __shared__ __align__(16) uint32_t sw[];
  if (kStaged) {
    int vec = 0;
    if ((reinterpret_cast<uintptr_t>(words) & 15) == 0) {
      vec = nwords >> 2;
      const uint4* src = reinterpret_cast<const uint4*>(words);
      for (int v = threadIdx.x; v < vec; v += blockDim.x)
        reinterpret_cast<uint4*>(sw)[v] = __ldg(src + v);
      vec *= 4;
    }
    for (int i = vec + threadIdx.x; i < nwords; i += blockDim.x)
      sw[i] = __ldg(words + i);
    __syncthreads();
  }
  const uint32_t* w = kStaged ? sw : words;
  int count = 0;
  uint32_t pos = 0;
  bool pos_set = false;
  if (nonfinite) {
    count = __ldg(nonfinite);
    pos = static_cast<uint32_t>(__ldg(nonfinite + 1));
    pos_set = (bq_word<kStaged>(w, pos >> 5) >> (pos & 31u)) & 1u;
  }
  const QuerySpan sp = query_span(keys, m);
  const long long g =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the head and the tail (at most 3 keys each), a key a thread
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const long long i = part == 0 ? (g < sp.head ? g : m) : sp.body_end + g;
    if (i >= m) continue;
    const uint32_t k[1] = {__ldg(keys + i)};
    keep[i] = count ? bq_alive_nonfinite<FAM, H, kPow2, 1>(
                          k, 1u, hashes, seed, q, count, pos, pos_set)
                    : bq_alive<FAM, H, kPow2, kStaged, 1>(k, 1u, w, hashes,
                                                          seed, q);
  }
  const uint4* kv = reinterpret_cast<const uint4*>(keys + sp.head);
  const long long step =
      static_cast<long long>(gridDim.x) * blockDim.x * QUERY_UNITS;
  for (long long u0 = static_cast<long long>(blockIdx.x) * blockDim.x *
                          QUERY_UNITS + threadIdx.x;
       u0 < sp.units; u0 += step) {
    uint32_t k[BQ_KEYS];
    uint32_t alive = 0;
#pragma unroll
    for (int j = 0; j < QUERY_UNITS; ++j) {
      const long long u = u0 + static_cast<long long>(j) * blockDim.x;
      const uint4 x = u < sp.units ? __ldcs(kv + u) : make_uint4(0, 0, 0, 0);
      k[4 * j] = x.x;
      k[4 * j + 1] = x.y;
      k[4 * j + 2] = x.z;
      k[4 * j + 3] = x.w;
      if (u < sp.units) alive |= 0xFu << (4 * j);
    }
    const uint32_t in = alive;
    alive = count ? bq_alive_nonfinite<FAM, H, kPow2, BQ_KEYS>(
                        k, alive, hashes, seed, q, count, pos, pos_set)
                  : bq_alive<FAM, H, kPow2, kStaged, BQ_KEYS>(
                        k, alive, w, hashes, seed, q);
#pragma unroll
    for (int j = 0; j < QUERY_UNITS; ++j) {
      if (!((in >> (4 * j)) & 1u)) break;
      const long long u = u0 + static_cast<long long>(j) * blockDim.x;
      const uint32_t a = (alive >> (4 * j)) & 0xFu;
      if (vec_out) {
        // bytes 0/1 of the 4 keys, little-endian
        const uint32_t b = (a & 1u) | ((a & 2u) << 7) | ((a & 4u) << 14) |
                           ((a & 8u) << 21);
        __stcs(reinterpret_cast<unsigned*>(keep + sp.head) + u, b);
      } else {
        const long long i = sp.head + 4 * u;
#pragma unroll
        for (int t = 0; t < 4; ++t) keep[i + t] = (a >> t) & 1u;
      }
    }
  }
}

// The instantiations: the main path's 3 hashes unrolled or any number at
// run time, staged or not, a power-of-two nbits or not.
template <int FAM, bool kStaged, bool kPow2>
const void* bq_kernel_h(int H) {
  return H == 3 ? reinterpret_cast<const void*>(
                      bloom_query_persistent<FAM, 3, kStaged, kPow2>)
                : reinterpret_cast<const void*>(
                      bloom_query_persistent<FAM, 0, kStaged, kPow2>);
}

template <int FAM>
const void* bq_kernel(int H, bool staged, bool pow2) {
  if (staged)
    return pow2 ? bq_kernel_h<FAM, true, true>(H)
                : bq_kernel_h<FAM, true, false>(H);
  return pow2 ? bq_kernel_h<FAM, false, true>(H)
              : bq_kernel_h<FAM, false, false>(H);
}

const void* bq_pick(int family, int H, bool staged, bool pow2) {
  if (family == 1) return bq_kernel<1>(H, staged, pow2);
  if (family == 2) return bq_kernel<2>(H, staged, pow2);
  return bq_kernel<0>(H, staged, pow2);
}

// The route, here alone: a filter of BLOOM_QUERY_STAGED_BYTES or less is
// staged in each CTA's shared memory.
size_t bq_smem(uint32_t nbits) {
  const size_t bytes = static_cast<size_t>((nbits + 31u) / 32u) * 4;
  return bytes <= BLOOM_QUERY_STAGED_BYTES ? bytes : 0;
}

}  // namespace

// The retired build: staged in each CTA's shared memory when the filter
// fits 48 KB, else global atomics (see the header).
extern "C" int bloom_build_global(const uint32_t* keys, const uint8_t* mask,
                                  uint32_t* words, long long m,
                                  uint32_t nbits, int H, uint32_t seed,
                                  int family, int grid, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>((nbits + 31u) / 32u) * 4;
  const int staged = bytes <= 48 * 1024;
  bloom_build_kernel<<<grid, 256, staged ? bytes : 0, stream>>>(
      keys, mask, words, m, nbits, H, seed, family, staged);
  return cudaGetLastError();
}

// Opt the cluster kernel into ``smem`` bytes of shared memory a CTA and
// into clusters of more than 8 CTAs.
static cudaError_t bloom_cluster_prep(size_t smem) {
  cudaError_t e = cheetah_launch_prep(
      reinterpret_cast<const void*>(bloom_cluster_kernel), smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(bloom_cluster_kernel),
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

static cudaLaunchConfig_t bloom_cluster_config(int clusters, int K,
                                               size_t smem,
                                               cudaLaunchAttribute* attr,
                                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters) * K);
  cfg.blockDim = dim3(BLOOM_CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster build's layout for a filter of nbits and H hashes on the
// current device, into out[3]: K, the fewest CTAs a cluster (2, 4, 8 or 16)
// whose shared memory holds the slices, bins and inboxes (0: none does, or
// H > BLOOM_MAX_H); the words of a slice; and the clusters of K that the
// card holds at once (cudaOccupancyMaxActiveClusters; 0: none). Returns 0
// or a CUDA error.
extern "C" int bloom_cluster_plan(uint32_t nbits, int H, int* out) {
  out[0] = out[1] = out[2] = 0;
  if (H < 1 || H > BLOOM_MAX_H) return cudaSuccess;
  const int nwords = static_cast<int>((nbits + 31u) / 32u);
  for (int K = 2; K <= BLOOM_MAX_CLUSTER; K *= 2) {
    const int slice = bloom_cluster_slice(nwords, K);
    const size_t smem = bloom_cluster_smem(slice, K, H);
    if (smem > CHEETAH_MAX_SMEM) continue;
    cudaError_t e = bloom_cluster_prep(smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = bloom_cluster_config(1, K, smem, attr, 0);
    e = cudaOccupancyMaxActiveClusters(
        &out[2], reinterpret_cast<const void*>(bloom_cluster_kernel), &cfg);
    if (e != cudaSuccess) return e;
    out[0] = K;
    out[1] = slice;
    return cudaSuccess;
  }
  return cudaSuccess;
}

// The cluster build in clusters of K CTAs (K from bloom_cluster_plan), each
// CTA a slice of bloom_cluster_slice(nwords, K) words, on at most
// ``clusters`` clusters and no more than give each cluster a round of keys
// (BLOOM_KPT a thread), since each also zeroes and flushes a whole copy;
// ``words`` starts zeroed.
extern "C" int bloom_build(const uint32_t* keys, const uint8_t* mask,
                           uint32_t* words, long long m, uint32_t nbits,
                           int H, uint32_t seed, int family, int K,
                           int clusters, cudaStream_t stream) {
  if (K < 1 || K > BLOOM_MAX_CLUSTER || clusters < 1 || H < 1 ||
      H > BLOOM_MAX_H || m < 1)
    return cudaErrorInvalidValue;
  const long long per = static_cast<long long>(K) * BLOOM_CLUSTER_THREADS *
                        BLOOM_KPT;
  if ((m + per - 1) / per < clusters)
    clusters = static_cast<int>((m + per - 1) / per);
  const int nwords = static_cast<int>((nbits + 31u) / 32u);
  const int slice = bloom_cluster_slice(nwords, K);
  const size_t smem = bloom_cluster_smem(slice, K, H);
  cudaError_t e = bloom_cluster_prep(smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      bloom_cluster_config(clusters, K, smem, attr, stream);
  e = cudaLaunchKernelEx(&cfg, bloom_cluster_kernel, keys, mask, words, m,
                         nbits, H, seed, family, slice,
                         bloom_cluster_cap(K, H), clusters);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The retired query (bloom_query_kernel: a grid-stride loop, a key a
// thread an iteration, its probes one after another), for holding the
// persistent query against it; launched by no entry point of the package.
extern "C" int bloom_query_grid(const uint32_t* words, const uint32_t* keys,
                                uint8_t* keep, long long m, uint32_t nbits,
                                int H, uint32_t seed, int family, int grid,
                                cudaStream_t stream) {
  bloom_query_kernel<<<grid, 256, 0, stream>>>(words, keys, keep, m, nbits, H,
                                               seed, family);
  return cudaGetLastError();
}

// The query's plan on the current device, into out[2]: the route (1: the
// words staged in each CTA's shared memory, 0: read from global memory)
// and the persistent grid's CTAs.
extern "C" int bloom_query_plan(uint32_t nbits, int H, int family, int* out) {
  const size_t smem = bq_smem(nbits);
  out[0] = smem > 0;
  const QueryHash q = query_hash(nbits, family);
  return query_ctas(bq_pick(family, H, smem > 0, q.pow2), smem, &out[1]);
}

// The persistent query: keep[m] of the keys against the packed words of
// nbits; ``nonfinite`` (int32[2] on the device, or null) as
// bloom_query_persistent takes it; ``ctas`` from bloom_query_plan.
extern "C" int bloom_query(const uint32_t* words, const uint32_t* keys,
                           uint8_t* keep, long long m, uint32_t nbits, int H,
                           uint32_t seed, int family, const int* nonfinite,
                           int ctas, cudaStream_t stream) {
  if (m < 1) return cudaSuccess;
  const size_t smem = bq_smem(nbits);
  QueryHash q = query_hash(nbits, family);
  const void* fn = bq_pick(family, H, smem > 0, q.pow2);
  cudaError_t e = cheetah_launch_prep(fn, smem);
  if (e != cudaSuccess) return e;
  int nwords = static_cast<int>((nbits + 31u) / 32u);
  int vec_out = query_vector_out(keep, 1, keys, m);
  void* args[] = {&words, &keys, &keep, &m, &nwords, &H,
                  &seed,  &q,    &nonfinite, &vec_out};
  e = cudaLaunchKernel(fn, dim3(query_grid(ctas, keys, m)),
                       dim3(QUERY_THREADS), args, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}
