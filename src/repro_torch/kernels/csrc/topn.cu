// Randomized TOP-N pruning (paper Ex. 7) on Hopper: pass 1 and pass 2.
//
// topn_pass1 replaces two pallas_calls of the JAX package:
//   topn_prune_kernel         src/repro/kernels/topn_prune.py:49  (S = 1)
//   topn_shard_states_kernel  src/repro/kernels/parallel.py:86    (S shards)
// and, at B = 1, the engine's per-entry scan core.topn.topn_rand_prune
// (src/repro/core/topn.py:38-69, a lax.scan): keep = x >= row[w - 1], and
// the row takes a sorted insert when x > row[w - 1] (pos = #(x <= row)).
//
// B = 1: the row-parallel walk. An entry reads and writes only its row,
// hash_mod(shard-local index, d, seed), so a lane is d independent chains.
// The stable partition of rowpar.cuh, by index (each entry keeps its value's
// 32 bits and its index), puts each segment (lane, row) in stream order;
// then topn_walk takes one warp a segment, its entries 32 at a time through
// the cp.async ring of rowpar.cuh, the row's w <= 32 values in registers
// (slot j on lane j). A step is one ballot: the first entry of the 32 whose
// value beats the row's minimum inserts; the entries before it keep iff
// value >= minimum; the insert moves the slots after pos up by a shuffle,
// and the step repeats from the next entry. Most steps see no insert: the
// matrix takes about a hundred inserts a row on the main path. Walking in
// stream order keeps the stored bits of +-0 and never stores or keeps a NaN,
// as the scan does. Rows of w > 32 take topn_walk_wide: the same steps on a
// row in shared memory.
// What bounds the walk: bytes (the partition reads x twice and writes 8
// bytes an entry; the walk reads them and scatters keep), not its chain,
// which is the costliest segment's inserts.
//
// B > 1: topn_pass1_block, block semantics as in src/repro/kernels/ref.py:
// one CTA a lane, its f32[d][w] descending matrix in shared memory; every
// keep decision of a chunk reads the pre-chunk matrix, and each row takes
// one sorted insert per chunk, its best candidate (a per-row atomicMax on
// the order-preserving integer image of the float). Bounded by its chain
// of shard_len / B chunk steps: two barriers and a pass over the d rows.
//
// topn_pass1_serial is the kernel the walk replaced (one thread of a CTA
// walks its lane's entries in order). No entry point of the package
// launches it; chip_smoke.py holds the walk against it at full size.
//
// topn_apply replaces topn_apply_kernel (src/repro/kernels/parallel.py:126):
// keep = x[i] >= rowmin[hash(i mod shard_len)], elementwise over m. It is
// bound by bytes (read x, write keep); rowmin is staged in shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "rowpar.cuh"

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

// One warp a segment g = lane * d + row over its entries [starts[g],
// starts[g + 1]) of the partitioned stream (value bits, index), loaded
// through the cp.async ring of rowpar.cuh. Slot j of the row is lane j's r.
__global__ void __launch_bounds__(ROWPAR_THREADS)
    topn_walk(const uint2* __restrict__ part, const int* __restrict__ starts,
              uint8_t* __restrict__ keep, float* __restrict__ states,
              long long nseg, int w) {
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
  float r = cheetah_neg_value();
  float rmin = r;  // slot w - 1
  for (int c = 0; c < chunks; ++c) {
    __syncwarp();  // every lane is done with the slot this issue refills
    issue(c + ROWPAR_STAGES - 1);
    rowpar_wait();
    __syncwarp();  // every lane's copy of chunk c is visible to the warp
    const uint2 e = ring[warp][c % ROWPAR_STAGES][lane];
    const int n = min(32, hi - lo - (c << 5));
    const float v = __uint_as_float(e.x);
    bool kp = false;
    for (int done = 0;;) {
      const bool open = lane >= done && lane < n;
      const unsigned ins = __ballot_sync(ROWPAR_FULL, open && v > rmin);
      const int first = ins ? __ffs(ins) - 1 : n;
      if (open && lane < first) kp = v >= rmin;
      if (first == n) break;
      // entry `first` keeps and is inserted at pos = #(value <= slot)
      const float cv = __shfl_sync(ROWPAR_FULL, v, first);
      const int pos = __popc(__ballot_sync(ROWPAR_FULL, lane < w && cv <= r));
      const float up = __shfl_up_sync(ROWPAR_FULL, r, 1);
      if (lane == pos)
        r = cv;
      else if (lane > pos && lane < w)
        r = up;
      rmin = __shfl_sync(ROWPAR_FULL, r, w - 1);
      if (lane == first) kp = true;
      done = first + 1;
    }
    if (lane < n) keep[e.y] = kp;
  }
  rowpar_wait_all();
  if (lane < w) states[g * w + lane] = r;
}

// The walk for rows wider than a warp's registers (w > 32): one warp a
// segment as above, the row in shared memory, its entries loaded 32 at a
// time (one a lane); an insert counts pos and shifts the row lane-strided.
__global__ void __launch_bounds__(ROWPAR_THREADS)
    topn_walk_wide(const uint2* __restrict__ part,
                   const int* __restrict__ starts, uint8_t* __restrict__ keep,
                   float* __restrict__ states, long long nseg, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * warps + warp;
  if (g >= nseg) return;  // whole warps
  float* s = reinterpret_cast<float*>(smem) + static_cast<size_t>(warp) * w;
  for (int i = lane; i < w; i += 32) s[i] = cheetah_neg_value();
  __syncwarp();
  const int lo = starts[g];
  const int hi = starts[g + 1];
  float rmin = s[w - 1];
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int n = min(32, hi - c0);
    const uint2 e = lane < n ? part[c0 + lane] : make_uint2(0u, 0u);
    const float v = __uint_as_float(e.x);
    bool kp = false;
    for (int done = 0;;) {
      const bool open = lane >= done && lane < n;
      const unsigned ins = __ballot_sync(ROWPAR_FULL, open && v > rmin);
      const int first = ins ? __ffs(ins) - 1 : n;
      if (open && lane < first) kp = v >= rmin;
      if (first == n) break;
      const float cv = __shfl_sync(ROWPAR_FULL, v, first);
      unsigned cnt = 0;
      for (int i = lane; i < w; i += 32) cnt += cv <= s[i];
      const int pos = static_cast<int>(__reduce_add_sync(ROWPAR_FULL, cnt));
      rowpar_shift(s + pos, w - 1 - pos, lane);
      if (lane == 0) s[pos] = cv;
      __syncwarp();
      rmin = s[w - 1];
      if (lane == first) kp = true;
      done = first + 1;
    }
    if (lane < n) keep[e.y] = kp;
  }
  const long long o = g * w;
  for (int i = lane; i < w; i += 32) states[o + i] = s[i];
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

// Shared memory of the block kernel (B > 1); the walk needs none of it.
extern "C" size_t topn_pass1_smem(int d, int w, int block) {
  (void)block;
  return static_cast<size_t>(d) * w * sizeof(float) +
         static_cast<size_t>(d) * sizeof(unsigned);
}

extern "C" size_t topn_pass1_workspace(int shards, int shard_len, int d,
                                       int block) {
  return block == 1 ? topn_work(shards, shard_len, d).total : 0;
}

extern "C" int topn_pass1(const float* x, uint8_t* keep, float* states,
                          int shards, int shard_len, int d, int w, int block,
                          uint32_t seed, unsigned char* work,
                          cudaStream_t stream) {
  if (block > 1) {
    const size_t smem = topn_pass1_smem(d, w, block);
    cudaError_t err = cheetah_launch_prep(
        reinterpret_cast<const void*>(topn_pass1_block), smem);
    if (err != cudaSuccess) return err;
    topn_pass1_block<<<shards, block, smem, stream>>>(x, keep, states,
                                                      shard_len, d, w, seed);
    return cudaGetLastError();
  }
  if (w < 1 || (w > 32 && rowpar_wide_warps(static_cast<size_t>(w) * 4) == 0))
    return cudaErrorInvalidValue;
  const TopnWork k = topn_work(shards, shard_len, d);
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
    topn_walk<<<blocks, ROWPAR_THREADS, 0, stream>>>(part, starts, keep,
                                                     states, nseg, w);
    return cudaGetLastError();
  }
  const int warps = rowpar_wide_warps(static_cast<size_t>(w) * 4);
  const size_t smem = static_cast<size_t>(warps) * w * sizeof(float);
  err = cheetah_launch_prep(reinterpret_cast<const void*>(topn_walk_wide), smem);
  if (err != cudaSuccess) return err;
  topn_walk_wide<<<static_cast<unsigned>((nseg + warps - 1) / warps),
                   warps * 32, smem, stream>>>(part, starts, keep, states,
                                               nseg, w);
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

extern "C" int topn_apply(const float* x, const float* rowmin, uint8_t* keep,
                          long long m, int shard_len, int d, uint32_t seed,
                          int grid, cudaStream_t stream) {
  const int staged = static_cast<size_t>(d) * sizeof(float) <= 48 * 1024;
  const size_t smem = staged ? static_cast<size_t>(d) * sizeof(float) : 0;
  topn_apply_kernel<<<grid, 256, smem, stream>>>(x, rowmin, keep, m, shard_len,
                                                 d, seed, staged);
  return cudaGetLastError();
}
