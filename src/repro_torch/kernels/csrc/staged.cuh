// The staged stream of the one-CTA-a-lane block kernels (topn_pass1_block in
// topn.cu, distinct_pass1_block in distinct.cu).
//
// A block kernel walks its lane in chunks of B entries (one a thread) with
// two block barriers a chunk: its chain is shard_len / B steps. The entries
// reach it through a ring of `stages` stages in shared memory, each of `cps`
// chunks, so no step waits on device memory: the whole block copies a
// stage with cp.async, 16 bytes a thread, `stages - 1` stages ahead of the
// chunk being walked. A lane may start at any 4-byte offset (a view into a
// column): a stage's first entries up to a 16-byte boundary, and its last
// ones past the last, go by 4-byte copies, and the stage sits in its slot
// at the same offset mod 16 as in global memory (mis entries in), so that
// every 16-byte copy is aligned at both ends.
//
// The schedule, in the step of chunk c, before its first barrier (the
// step then fetches chunk c + 1 from the ring, which every thread waited
// for a step earlier):
//   - if chunk c + 1 starts stage s, issue stage s + stages - 1 into the
//     slot of stage s - 1, whose last chunk every thread fetched in the
//     last step, before its barriers;
//   - if chunk c + 2 starts stage s, wait for this thread's copies of
//     stage s; the step's barriers then make every thread's copies visible
//     before anyone fetches from it.
// Each stage is one copy group of each thread. staged_plan fits the ring
// into the shared memory the kernel's state leaves.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"
#include "rowpar.cuh"

#define STAGED_ENTRIES 4096  // entries a stage at most (16 KB of keys)
#define STAGED_STAGES 4      // stages of the ring at most

static inline size_t staged_align(size_t n) { return (n + 15) & ~size_t(15); }

struct StagedPlan {
  int cps;       // chunks a stage, at least 2
  int stages;    // stages of the ring, 2..STAGED_STAGES
  size_t ring;   // offset of the ring (after the state)
  size_t slot;   // entries a slot of the ring: cps * B, 4 for the offset,
                 // rounded up to 16 bytes
  size_t total;  // dynamic shared memory of the launch
};

static inline StagedPlan staged_layout(size_t state, int block, int cps,
                                       int stages) {
  StagedPlan p;
  p.cps = cps;
  p.stages = stages;
  p.ring = staged_align(state);
  p.slot = (static_cast<size_t>(cps) * block + 7) & ~size_t(3);  // 16 B
  p.total = p.ring + static_cast<size_t>(stages) * p.slot * 4;
  return p;
}

// The largest ring that fits beside `state` bytes: STAGED_ENTRIES entries a
// stage and STAGED_STAGES stages, halving the chunks a stage down to 2 and
// then dropping stages down to 2. That last layout is returned when nothing
// fits (its total is then above CHEETAH_MAX_SMEM and the launch is refused).
static inline StagedPlan staged_plan(size_t state, int block) {
  int cps0 = STAGED_ENTRIES / block;
  if (cps0 < 2) cps0 = 2;
  for (int stages = STAGED_STAGES; stages >= 2; --stages)
    for (int cps = cps0; cps >= 2; cps >>= 1) {
      const StagedPlan p = staged_layout(state, block, cps, stages);
      if (p.total <= CHEETAH_MAX_SMEM) return p;
    }
  return staged_layout(state, block, 2, 2);
}

// Wait until at most n of this thread's copy groups are in flight.
__device__ __forceinline__ void staged_wait(int n) {
  if (n <= 0)
    rowpar_wait_for<0>();
  else if (n == 1)
    rowpar_wait_for<1>();
  else if (n == 2)
    rowpar_wait_for<2>();
  else
    rowpar_wait_for<3>();
}

// The lane's stream as the block copies it and as thread t reads it, with
// a cursor on the last chunk fetched (counters, no division on the chain).
struct StagedRing {
  const uint32_t* x;  // the lane's first entry
  uint32_t* ring;     // [stages][slot]
  int t, block, cps, stages, nchunks;
  size_t slot;
  int s = 0, k = 0, sl = 0;      // stage, chunk in it, slot of the cursor
  const uint32_t* p = nullptr;   // this thread's entry at the cursor

  // Entries of stage s before a 16-byte boundary of global memory.
  __device__ __forceinline__ int mis(int st) const {
    return static_cast<int>(
        (reinterpret_cast<uintptr_t>(x + static_cast<long long>(st) * cps *
                                             block) >> 2) & 3);
  }

  // Issue stage st (nothing past the lane's last chunk) into slot sli, as
  // one copy group.
  __device__ __forceinline__ void issue(int st, int sli) {
    const int c0 = st * cps;
    if (c0 < nchunks) {
      const uint32_t* g = x + static_cast<long long>(c0) * block;
      const int n = min(cps, nchunks - c0) * block;
      const int m = mis(st);
      uint32_t* dst = ring + static_cast<size_t>(sli) * slot + m;
      const int head = min((4 - m) & 3, n);
      const int quads = (n - head) >> 2;
      const int tail = n - head - (quads << 2);
      for (int j = t; j < quads; j += block)
        rowpar_cp<16>(dst + head + 4 * j, g + head + 4 * j, true);
      if (t < head) rowpar_cp<4>(dst + t, g + t, true);
      if (t < tail) {
        const int e = head + 4 * quads + t;
        rowpar_cp<4>(dst + e, g + e, true);
      }
    }
    rowpar_commit();
  }

  // Before the walk: stages 0 .. stages-1 issued into slots 0 .. stages-1,
  // stage 0 landed. The caller's barrier follows before first().
  __device__ __forceinline__ void start() {
    for (int st = 0; st < stages; ++st) issue(st, st);
    staged_wait(stages - 1);
  }

  // This thread's entry of chunk 0.
  __device__ __forceinline__ uint32_t first() {
    p = ring + mis(0) + t;
    return *p;
  }

  // In the step of chunk c (c + 1 < nchunks), before its first barrier:
  // this thread's entry of chunk c + 1, after the issue and the wait of the
  // schedule above.
  __device__ __forceinline__ uint32_t next() {
    if (++k == cps) {  // chunk c + 1 starts stage s + 1
      k = 0;
      ++s;
      const int prev = sl;
      sl = sl + 1 == stages ? 0 : sl + 1;
      issue(s + stages - 1, prev);
      p = ring + static_cast<size_t>(sl) * slot + mis(s) + t;
    } else {
      p += block;
    }
    if (k == cps - 1) staged_wait(stages - 2);  // chunk c + 2 starts a stage
    return *p;
  }
};
