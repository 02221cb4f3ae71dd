#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its main path on one card.

    python3 chip_smoke.py

Phases, one line each, and a non-zero exit on any failure:

1. build   compile the kernels from ``src/repro_torch/kernels/csrc``.
2. kernels each kernel against its plain PyTorch version on the card,
           bit-identical keep masks, states and tables, at B in {1, 256}, S
           in {1, 8, 128}, ragged m, d = 4096 for DISTINCT, two seeds; both
           APH associations and SUM for SKYLINE, both hash families and
           table dtypes for Count-Min; both hash families, with and without
           a mask, for Bloom; all four aggregates for the GROUP BY scan;
           the ``topn_det`` ladder scan (negative values, N above a shard,
           w = 4 and 8), LRU DISTINCT (small caches with hits at every
           slot) and the RLE run scan at block 64 and 256 (ragged R, one
           run, all-distinct runs, negative values, N above the rows,
           several chunks at w = 32, NaN of both signs, +-0, +-inf and
           values near FLT_MAX, zero-length runs inside the column, a
           warm-up ending at a chunk boundary and mid-chunk, and the wrap:
           runs of 2^30 that take seen past 2^31); the Bloom cluster build
           by its C entry, whatever route the wrapper takes for the shape
           (JOIN F_A's shape with and without a mask, nbits 2^24 - 37 and
           600001, m = 7 and m = 0), and the wrapper on each; the
           persistent Count-Min and Bloom queries (every table dtype and
           hash family, no threshold and an int and a float one, tables
           and filters on both sides of the shared-memory route, m = 0, 1,
           3, 4097 and 2^20 + 3, keys as views 1 and 3 entries into their
           storage, tables with NaN, +-inf, -0, FLT_MAX and subnormal
           counters and bit vectors with a NaN or an infinity: Queue 3
           A21-A24, A24's table also through the retired query); the
           row-parallel
           DISTINCT and GROUP BY walks on adversarial inputs (a hot key,
           one row, two alternating keys, d = 37 and d = 70001, float32
           keys, invalid entries, the hot key in slot w - 1, rows of more
           than 32 slots, which the walks keep in shared memory); the B = 1
           TOP-N walk and the SKYLINE prefix merge (B = 1 and 32) on
           ascending, descending, all-equal and +-0 streams, NaN first,
           mid-lane and at a chunk boundary, values and SUM scores at and
           below NEG, d = 1, 37, 512 and w = 1 to 40; the chunked ladder
           on ascending, all-equal, NaN, +-inf / -0 / negative and
           near-FLT_MAX streams, N inside a chunk, at a chunk boundary
           +-1 and past the shard, w = 1, 8, 32; the DISTINCT block walk
           at B = 2, 32, 256 on uniform, zipf, small-universe and float32
           streams and on the trap stream BLOCK_TRAP; both B > 1 forms of
           TOP-N (the block walk and the block kernel) at B = 2, 32, 256,
           d = 1, 37, 512, w = 1 to 40 on random, ascending, all-equal and
           +-0 streams, NaNs of both signs mid-block and at a block
           boundary, and values at and around NEG; the DISTINCT block kernel
           beside its block walk on the walk's streams; the staged block
           kernels of TOP-N and DISTINCT (their C entries, and pass 1 as
           dispatched) at B = 256, S = 8 and 128, lanes of one chunk and of
           37 (not a whole number of stages), on the main-path columns, a
           stream on which every entry inserts, all-equal values among +-0
           and NaNs of both signs, float32 DISTINCT keys, d = 1, w = 64 for
           TOP-N, and the columns as views 1 and 3 entries into their
           storage; the lowest-owner
           distinct_apply on a hot key that every shard caches, a key that
           only the top lane holds and float32 keys, w = 4, 40 (and 80,
           whose table is built in place); topn_apply in both families
           (the kernels' one-hot read, the engine's direct read) on shards
           of L % 4 = 0, 1, 2, 3 entries, views 1, 2 and 3 entries into
           their storage, merged matrices of w = 1 and 8 read in place, d
           up to 60000 (its minima read from global memory), and merged
           columns holding +inf, -inf, NaN, two infinities, +-0 and
           subnormals. Then the
           engine's dtype handling: run_query TOP-N on an int32 column and
           DISTINCT on an int32 and a float32 column, on the card and on a
           CPU copy of the table; and int32 keys of both signs through
           ``kernels.ops``' Bloom and Count-Min entry points (the Pallas
           kernels' signed hash, ROADMAP Queue 3 A11) at widths 64, 4096
           and 2^24, against their plain versions; float16 Count-Min tables
           (both hash families) bit for bit against the plain build, which
           adds in f16 in entry order (Queue 3 A20: 3000 unit weights on one
           key read 2048), with each build's time and bound; and ROADMAP
           Queue 3 A27 (phase_kernels_a27): TOP-N pass 1 in the kernels'
           family keeps as the Pallas one-hot read of the row minimum does
           (the smallest input; both B > 1 forms and B = 1 on streams
           salted with +inf and NaN, against the plain version; the salted
           2^25-entry column at S = 128 against the plain version on the
           card, and the fix-up, topn_onehot_fixup, against ref.onehot_keep
           at S = 1 and 128, with its time).
3. main    the main path on a 2^25-row uservisits table and a 2^20-row
           rankings table (one worker's partition of the Big Data
           benchmark): ``run_query`` TOP-N (randomized and the
           threshold ladder), DISTINCT (FIFO and LRU, the default),
           SKYLINE, HAVING (COUNT and SUM), JOIN (the benchmark's Query 3),
           FILTER (Query 1, and a formula with an unsupported predicate)
           and GROUP BY (Query 2, SUM and COUNT); the ladder TOP-N and LRU
           DISTINCT again on dictionary- and RLE-encoded columns, whose
           keep masks must equal the plain column's and whose decoded
           survivors the plain rows; ``engine_prune`` two_pass with 128
           shards, plain and encoded; and the thirteen ``kernels.ops`` entry
           points, the run-level RLE pair on bench_encoded.py's layout
           (2^19 runs of 64), each equal to the flat scan of the expanded
           column. Answers must be exact (GROUP BY SUM within 1e-2 relative
           of an f64 sum, as the JAX package's own test holds it) and every
           keep mask a superset of the true survivors. Launch counts are set
           to 0 before each path and read after it; each path is then
           called once more, for its time as a repeated query meets it.
   mesh    mesh mode (right after phase main): the seven engine calls of
           section 5 at mode="mesh", S = 128, pass2 master, mesh and auto,
           on (a) default_mesh(), one position on the card, (b) that
           position in a one-rank NCCL group over a HashStore (NCCL's
           all-gather on the card) and (c) 8 positions on the card (every
           pass on lane sub-ranges, every apply with its lane base): keep,
           merged state and emissions bit for bit against two_pass at
           S = 128, the report's counts against the masks, each call's
           wall time against two_pass's and the state bytes it gathered;
           a run_query a query kind (JOIN's filters ORed over the workers)
           on (c)'s 8 workers, each answer phase main's; a run_queries
           DISTINCT group whose resident wave is one gather; a
           PruneStream on (c) against one-shot two_pass on the lane view;
           execute_plan of a mesh plan, its keep flat. Launch counts are
           set to 0 just before each mesh run and read just after it, the
           two_pass references run outside those windows: each engine
           call's pass-1 kernels launch D times its two_pass's (once a
           position) and its apply kernel (D if resident else 1) x chunks
           times, and every kernel of the mesh paths is launched by them.
   planner each section-5 engine call's merge cost and one lane's state
           bytes measured on the card (calibrate_merge_cost), the lane count
           shards="auto" resolves at 2^25 entries, the two_pass call at
           that count bit-identical to the same call with the count given,
           and its time beside the 128-lane call's; options= against the
           keyword arguments.
   obs     every run_query and engine_prune path of phase main at the obs
           levels off, counters and trace: masks identical, counters equal
           to the masks and states they count, a Chrome trace written to a
           temporary file and parsed, and each call's wall time at off and
           at counters.
   stream  streaming and scan resume: each resumed B = 1 pass-1 kernel
           (TOP-N with its lane offset, DISTINCT FIFO and LRU, SKYLINE,
           GROUP BY, the ladder) at S = 128 and 1 on the whole column cut
           into 3 ragged pieces a lane, keep and state bit for bit against
           the one-pass kernel, and on a carried state against its plain
           version (lane 0, STREAM_PLAIN entries); PruneStream.close() over
           micro-batches of STREAM_BATCH (one pair ragged) bit for bit
           against one-shot two_pass on lane_view for the seven engine
           calls at merge_every 1 and 4, live against final, the kernels
           launched, each fold's host and device time, merge and close
           times, entries/s against the one-shot call, window_blocks, the
           lane states' data_ptr; the staleness slope sigma from
           merge_every 1, 4 and 16; and the f32 HAVING merge's time.
   tune    self-tuned plans (after phase batch): each engine call's
           candidate plans with keeps equal to the incumbent's on the
           whole column, a race with real clocks in a fresh plan cache,
           the cached replay, engine_prune(tune="race"), a dict-encoded
           DISTINCT; run_queries' DISTINCT LRU and GROUP BY SUM groups at
           tune off / race / cached with execute_plan_batch against
           execute_plan; the TPC-H subset suite at TUNE_SCALE rows against
           its plain-Python references; the launch counts of the phase.
   edges   the edges of the system (after phase tune): the token
           pipeline's batches() on a 2^20-document corpus (vocab 32000,
           seq_len 128, batch 64, dup_fraction 0.3) with the dedup block
           walk at B = 16, d = 1024 and 32768, and with the LRU scan; the
           fingerprints against a numpy fold of the whole corpus and the
           reference's per-document loop on its first 4096 documents; the
           block walk at B = 16 bit for bit against its plain version (a
           worker process) on the whole column, keep and state; the LRU
           run's keep against core.distinct_prune on the CPU (a worker) on
           its first 2^18 documents; the filter
           against numpy; every batch against a numpy packing of the
           survivors; RequestCache(d=256, w=4) over 2^16 zipf(1.2) prompts
           in 256 calls against the same calls on the CPU (a worker), first
           occurrences kept, reset honoured; the §7.2 protocol over three
           LRU DISTINCT queries' engine_prune_batch masks of 4096 entries
           (held bit for bit to the same call on a CPU copy) at drop 0 and
           0.02; pruned_topk of [64, 151936] logits over 16
           shards at k = 1 and 8 against torch.topk, with both times; the
           ms of each pipeline step, documents/s, tokens/s and the host s
           of corpus(); the µs a dedup call. The launch counts are zeroed
           before these paths and read after.
   serve   the LM serving path (after phase edges): qwen3-1.7b at full
           width (28 layers, d_model 2048, vocab padded to 152,064, 2.03 B
           parameters from the port's init on the card); 8 requests of 4
           distinct prompts through RequestCache, then
           ServeEngine.generate of 16 tokens from 8-token prompts with
           track_topn=16, its launch counts zeroed before the dedup and
           read after (topn_det_pass1 once a fold, the dedup's LRU walk
           and apply); the trace against torch.topk of the folded wire,
           0 < shipped <= entries, the ladder kernel against its plain
           version fold by fold on that wire; generate three times with
           and three without tracking, in turns, every token equal; the
           decode step's time and tok/s; the full-width prefill-via-
           decode logits against forward's (0.08 of the largest logit);
           the ten smoke archs' forward and a 4-step decode on the card
           against the CPU (SERVE_CARD_TOL), beside the CPU's shift from
           one bf16 ulp of one parameter.
4. subnormals
           every kernel that computes on f32 values (TOP-N, DISTINCT on
           float32 keys and SKYLINE pass 1 at S = 1 and 128, B = 1 and
           256, their applies, the GROUP BY scan in its four aggregates,
           the ladder, the RLE run scan, the f32 Count-Min build in both
           families) on columns with 1 entry in 16 replaced by +-k * 1e-40
           and 1 in 32 by +-0, bit for bit against its plain version
           (ROADMAP Queue 3 A25: XLA flushes f32 subnormals in compute and
           keeps them in copies); and A28 (subnormals_a28): f32 Count-Min
           tables whose weights take both signs add in entry order with a
           flush after each add, bit for bit against the plain build, with
           the time of each route.
5. timing  on the same tables, each kernel against its plain version at
           every shape the main path gives it (bit-identical keep, state and
           table on the whole table; the one-lane B = 1 scans on their
           first SCAN_PREFIX entries, and the S = 128 GROUP BY scan on each
           lane's first GROUPBY_PREFIX / S, rerun on that prefix for the
           state; the plain loops on CPU copies, except those whose time
           the kernels line reports, the pass-1 loops in HOST_WORKERS
           processes started before phase kernels),
           each Count-Min and Bloom query's device time, route, SASS
           instructions a key of its key loop and the issue floor they
           imply, host time a call, and a torch gather of the pre-hashed
           cells or words (a yardstick, not the same function; at JOIN's
           filters the card's L2 gather rate),
           the run-level RLE scan also on three layouts that prune
           (shuffled, shuffled below 0, descending), its median time, its C
           entry's time alone and queued back to back (its device time),
           its plain version's time and its bound; the Bloom cluster build
           beside the global-atomic kernel at JOIN's filters and over a
           sweep of m at JOIN's filter size (the readings of the wrapper's
           dispatch rule); and the time of the ``lut[code]`` decode
           gather. The row-parallel walks' bound is their longest chain on
           this run's stream (``walk_bound``); the TOP-N walk's and the
           SKYLINE prefix merge's is the most inserts one store takes on it
           (``prefix_bound``); the DISTINCT block walk's is the most
           inserting (row, block) groups one segment has on it
           (``block_walk_bound``), the TOP-N block walk's the most
           inserting (row, block) groups one segment has (``prefix_bound``).
           Both forms of DISTINCT and of TOP-N at B = 256 are timed at
           S = 1, 8, 16, 32, 64 and 128 (``time_block_forms``); each pass-1
           shape prints its time per chain step and its device time
           (``queued_ms``). torch.profiler splits each
           redesigned kernel into its internal kernels (distinct_apply into
           its table build and its lookups, the Bloom build into its
           zeroing and its cluster kernel),
           and a stream on which every
           entry inserts is timed. The Count-Min build prints the atomic
           instructions its compiled code uses and its layout (CTAs a
           lane, the int32 shadow's limit); the SKYLINE apply prints k, the
           merged points its compaction keeps, and the retired scan's time;
           both print their internal kernels' device times. Each phase
           prints its seconds.
           topn_apply prints its call and device time in both families and
           a yardstick (one torch.ge of the column against a precomputed
           vector of row minima).
6. witness the redesigned kernels against the serial kernels they
           replaced, bit for bit, over the whole 2^25-entry column: at S = 1
           DISTINCT FIFO and LRU, GROUP BY SUM and COUNT; at S = 1 and 128
           the chunked ladder, the DISTINCT and TOP-N block walks (against
           the block kernels, B = 256), the staged block kernels against the
           unstaged ones they replaced (topn_pass1_block_unstaged,
           distinct_pass1_block_unstaged, B = 256), and at B = 1 TOP-N and
           SKYLINE; at
           S = 128 the lowest-owner distinct_apply against the scan it
           replaced, after FIFO (B = 256 and 1) and LRU pass 1; the
           chunked RLE run scan against the one-CTA run scan on the 2^19
           timed runs and the three pruning layouts; the cluster Bloom
           build against the global-atomic kernel at JOIN's F_A and F_B;
           the partial-table Count-Min build against the atomic build it
           replaced (cms_build_atomic) at its four main-path shapes; the
           compacted SKYLINE apply against the slot-order scan
           (skyline_apply_scan) on both merged sets; the persistent
           Count-Min and Bloom queries against the grid-stride queries they
           replaced (cms_query_grid, bloom_query_grid) at every main-path
           shape; topn_apply against the apply it replaced
           (topn_apply_grid) at S = 128 after B = 1 and 256 pass 1; then
           the ``kernels`` JSON line (phase timing adds the fix-up's row,
           and holds the salted column at S = 1, B = 256 against its plain
           loop from a HostPlain worker).

Needs one CUDA card; exits non-zero without one. The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
MAX_CLOCK_HZ = 1.98e9          # H100 SXM boost clock, when nvidia-smi is mute
SMEM_CYCLES = 20               # floor taken for a shared-memory round trip
BARRIER_CYCLES = 20            # floor taken for a block barrier
SCAN_PREFIX = 1 << 16          # entries of the S = 1, B = 1 scan compared
M_MAIN = 1 << 25               # rows of the uservisits partition
SHARDS = 128
TOPN = dict(d=512, w=8)        # README quickstart: d=512, w=8, N=100
TOPN_N = 100
DISTINCT = dict(d=4096, w=4)   # 112 KB of shared memory per lane at B=256
SEEDS = (0, 7)
SKYLINE = dict(w=8, score="aph")
SKY_COLS = ("ad_revenue", "duration")
# (key column, value column, engine params) of the two HAVING queries
HAVING_COUNT = ("source_ip", "duration",
                dict(threshold=100_000, rows=3, width=4096, agg="count"))
HAVING_SUM = ("lang", "duration",
              dict(threshold=262_000_000, rows=3, width=1024, agg="sum"))
CMS_OPS = dict(rows=3, width=4096)   # ops.cms_build on source_ip
M_RANKINGS = 1 << 20           # rows of the rankings partition
# Big Data benchmark Query 3: uservisits JOIN rankings ON dest_url = page_url
JOIN = dict(nbits=1 << 24, num_hashes=3, payload_a="ad_revenue",
            payload_b="page_rank")
BLOOM_OPS = dict(nbits=1 << 15, num_hashes=3)  # ops.bloom_* on page_url[:4096]
BLOOM_OPS_KEYS = 4096
GROUPBY = dict(d=4096, w=4)    # Query 2: GROUP BY source_ip, 144 KB a lane
GROUPBY_PREFIX = 1 << 21       # entries of the S = 128 GROUP BY scan compared
HOST_WORKERS = 4               # processes that run phase timing's plain
                               # pass-1 loops on the host (HostPlain)
FP32_OPS_PER_S = 33.5e12       # H100 SXM FP32 instructions/s without FMA
TOPN_DET = dict(N=100, w=8)    # README batch example: mode="det", w=8
# bench_encoded.py's layout: 2^25 rows in runs of 64 (R = 2^19), sorted
# draws below 4096 for TOP-N, unsorted draws below 2048 for DISTINCT
RLE_RUN_LEN = 64
RLE_CHUNK = 2048               # runs a chunk of the run scan (topn_det.cu)
RLE_TOPN = dict(N=250, w=8)
RLE_DISTINCT = dict(d=256, w=4)
FADD_CYCLES = 4                # latency of one dependent f32 add (a fold)
REG_STEP_CYCLES = 4            # floor of a walk step on registers: one
                               # dependent compare-and-select
# the adversarial inputs of the row-parallel walks: (stream, d, w), at
# S = 1, 8 and 128 lanes of ROWPAR_LANE[S] entries
ROWPAR_LANE = {1: 2053, 8: 257, 128: 33}
ROWPAR_DISTINCT = (("hot key", 16, 4), ("one row", 1, 4),
                   ("alternating", 1, 2), ("uniform", 37, 3),
                   ("uniform", 70001, 2), ("float32", 8, 2),
                   ("uniform", 1, 40), ("hot key", 3, 64))
# (stream, d, w, aggregates); w = 1 keeps the hot key in slot w - 1
ROWPAR_GROUPBY = (("hot key", 16, 4, ("sum", "count", "min", "max")),
                  ("hot key", 2, 1, ("sum", "count", "min", "max")),
                  ("one row", 1, 4, ("sum", "count")),
                  ("alternating", 1, 2, ("sum", "count")),
                  ("uniform", 37, 3, ("sum", "count")),
                  ("uniform", 70001, 2, ("sum", "count")),
                  ("uniform", 1, 40, ("sum", "count", "min", "max")),
                  ("hot key", 2, 33, ("sum", "count")))
# the adversarial inputs of the B = 1 TOP-N walk, (d, w), and of the
# SKYLINE prefix merge, w (at B = 1 and B = 32), at S = 1, 8 and 128 lanes
# of ROWPAR_LANE[S] entries (rounded down to a multiple of 32 at B = 32)
PREFIX_TOPN = ((1, 1), (37, 8), (512, 8), (1, 33), (37, 40))
PREFIX_SKYLINE_W = (1, 8, 33)
PREFIX_SKYLINE_B = 32
# f32 values of the float32 DISTINCT case: conversions the JAX package's
# uint32 slots see (negatives, NaN, +-inf, non-integers, 2^32 and above)
FLOAT_KEYS = (-3.0, -0.0, 0.0, 4.5, float("nan"), float("inf"),
              -float("inf"), 2.0 ** 32, 5e9, 2.0 ** 31, 4.0, 7.0, 3.5)
DTYPE_ROWS = 1 << 14           # rows of the A2 card case's tables
F16_KEYS = 300                 # keys of the f16 Count-Min case (A20)
# the chunked ladder (csrc/topn_det.cu): entries a chunk, and its
# adversarial cases, S lanes of LADDER_LANE[S] entries (past one or more
# chunks) under each N and w; "n + 7" is N past the shard
LADDER_CHUNK = 4096
LADDER_LANE = {1: 3 * LADDER_CHUNK + 5, 8: 2 * LADDER_CHUNK + 3,
               128: LADDER_CHUNK + 1}
LADDER_NS = (100, LADDER_CHUNK - 1, LADDER_CHUNK, LADDER_CHUNK + 1, "n + 7",
             1 << 20)
LADDER_WS = (1, 8, 32)
# the DISTINCT block walk's cases, (stream, d, w) at every B of
# BLOCK_WALK_BS, S lanes of BLOCK_WALK_LANE[S] entries; a small universe
# fills its rows, and w = 64 takes the shared-memory walk
BLOCK_WALK_LANE = {1: 4096, 8: 1024, 128: 256}
BLOCK_WALK_BS = (2, 32, 256)
BLOCK_WALK_CASES = (("uniform", 4096, 4), ("uniform", 37, 3),
                    ("zipf", 64, 4), ("small universe", 16, 4),
                    ("small universe", 3, 64), ("float32", 8, 2))
# the TOP-N block cases: both B > 1 forms (the block walk and the block
# kernel) at every B of BLOCK_WALK_BS and (d, w) of TOPN_BLOCK_SHAPES, S
# lanes of BLOCK_WALK_LANE[S] entries; d = 1 puts a whole block in one
# group, w > 32 takes the shared-memory walk
TOPN_BLOCK_SHAPES = ((1, 1), (1, 8), (37, 8), (512, 8), (1, 33), (37, 40))
NEG_NAN_BITS = -4194304        # 0xFFC00000 as int32: x86's default NaN
# distinct_apply's cases: (S, w) with S lanes of DISTINCT_APPLY_LANE
# entries; w = 80 at S = 128 builds the lowest-owner table in place (its
# 2^15 slots do not fit shared memory)
DISTINCT_APPLY_LANE = {1: 4096, 8: 1024, 128: 256}
DISTINCT_APPLY_WS = {1: (4, 40), 8: (4, 40), 128: (4, 40, 80)}
# the smallest stream on which dropping every repeat of the previous key
# is wrong under block semantics (d = 1, w = 1, B = 2): entry 4 repeats
# entry 3, but entry 3's block inserted 9 over the 7 that entry 3 hit
BLOCK_TRAP = ((7, 7, 9, 7, 7, 11), (True, True, True, False, True, True))
# the staged block kernels' cases at B = 256 (phase_kernels_block_staged):
# S lanes of one chunk and of STAGED_CHUNKS chunks (two stages of 16 chunks
# and 5 more: not a whole number of stages), TOP-N at (d, w) in STAGED_TOPN
# and DISTINCT at STAGED_DISTINCT, the main-path shape first
STAGED_LANES = (8, 128)
STAGED_CHUNKS = 37
STAGED_TOPN = ((512, 8), (1, 8), (37, 64))
STAGED_DISTINCT = ((4096, 4), (1, 4), (37, 3))

FAILURES: list[str] = []
T_START = time.perf_counter()


def say(phase: str, **kw) -> None:
    """One line of a phase, led by the seconds since the script started."""
    print(f"[{phase}] t={time.perf_counter() - T_START:.1f} "
          + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
        say("FAIL", what=what)
    return ok


def same(a, b) -> bool:
    """Bit-identical tensors (uint32 compared through its int32 view)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def same_bits(a, b) -> bool:
    """Bit-identical tensors, every NaN as one (a NaN's sign and payload
    differ between the card and the host's plain run)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = (torch.where(t.isnan(), float("nan"), t).view(torch.int32)
                for t in (a.cpu(), b.cpu()))
    return same(a.cpu(), b.cpu())


def max_abs_err(pairs) -> float:
    import torch

    err = 0.0
    for a, b in pairs:
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if a.dtype == torch.bool:
            a, b = a.to(torch.int64), b.to(torch.int64)
        if a.numel():
            err = max(err, float((a.to(torch.float64)
                                  - b.to(torch.float64)).abs().max()))
    return err


def sync_time(fn):
    """(result, wall seconds) of fn() ending in a device synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def to_card(x):
    """x with every tensor in it moved to the card."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cuda()
    if isinstance(x, (tuple, list)):
        return type(x)(to_card(y) for y in x)
    return x


def on_host(fn, *args):
    """(fn(*args) on CPU copies of its tensors, with its tensors moved back
    to the card; fn's wall seconds). The plain loops take one step an entry
    or a block, of tensors of a few hundred elements: an operation costs a
    few us on the host and a launch on the card, so a loop runs 4-10 times
    faster on the host. Used for every plain run whose time is not the one
    the kernels line reports."""
    import torch

    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    t0 = time.perf_counter()
    out = fn(*cpu)
    return to_card(out), time.perf_counter() - t0


def _to_numpy(x):
    """x with every tensor in it as a numpy array (uint32 through its int32
    view, tagged), to cross a process boundary by value."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            return ("u32", x.view(torch.int32).numpy())
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_numpy(y) for y in x)
    return x


def _from_numpy(x):
    """The inverse of ``_to_numpy``, its tensors on the card."""
    import numpy as np
    import torch

    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).cuda()
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
        return torch.from_numpy(x[1]).cuda().view(torch.uint32)
    if isinstance(x, (tuple, list)):
        return type(x)(_from_numpy(y) for y in x)
    return x


_HOST_JOBS: dict = {}   # HostPlain's jobs, read by the forked workers


def _host_worker_init():
    import torch

    torch.set_num_threads(1)


def _host_job(key):
    """One HostPlain job in a worker: (its result as numpy, its seconds)."""
    fn, args = _HOST_JOBS[key]
    t0 = time.perf_counter()
    out = fn(*args)
    return _to_numpy(out), time.perf_counter() - t0


class HostPlain:
    """The plain pass-1 loops of phase timing that run on the host, on the
    whole 2^25-entry column (the one-lane B = 1 scans on their first
    SCAN_PREFIX entries), each in one of HOST_WORKERS processes forked
    once the kernels are built, on CPU copies of the main path's columns
    made from the same seed, so that they run beside phase kernels, which
    times nothing, and not beside the call times of phase timing; ``get``
    waits for one. The loops take one Python step a block (an entry at
    B = 1) and minutes each in a row; the workers do no CUDA work, each
    runs on one thread, and they are stopped by ``close``. The seconds
    returned are each loop's own, in its worker."""

    def __init__(self, torch, P, R):
        import multiprocessing

        from repro_torch.query import make_uservisits

        table = make_uservisits(M_MAIN, seed=0)
        cols = {"topn_pass1": table.cols["ad_revenue"].cpu(),
                "distinct_pass1": table.cols["source_ip"].cpu(),
                "skyline_pass1": torch.stack(
                    [table.cols[c].float() for c in SKY_COLS], -1).cpu()}
        del table
        self.cols = cols
        jobs = {}
        for name, v in cols.items():
            plain = pass1_fns(name, P, R)[1]
            for _, S, B in PASS1_SHAPES[1:]:
                u = v[:SCAN_PREFIX] if S == 1 and B == 1 else v
                jobs[(name, S, B)] = (
                    lambda z, S=S, B=B, plain=plain: plain(z, S, B), (u,))
        jobs[("topn_pass1_a27", 1, 256)] = (
            lambda z: R.topn_block_ref(z[None], block=256, return_state=True,
                                       onehot=True, **TOPN),
            (a27_salt(torch, cols["topn_pass1"], 1),))
        fs = cols["distinct_pass1"]
        jobs[("distinct_pass1_lru", SHARDS, 1)] = (
            lambda z: R.distinct_lru_ref(z, d=DISTINCT["d"],
                                         w=DISTINCT["w"], return_state=True),
            (fs.view(SHARDS, -1),))
        # phase batch's plain versions of the batched walks, on the first
        # BATCH_PREFIX entries: short, so they go first
        batch = batch_host_jobs(cols, torch)
        jobs.update(batch)
        _HOST_JOBS.clear()
        _HOST_JOBS.update(jobs)
        # the longest loops first (the walks at S = 128, then the block
        # walks, then the prefix scans), so that they end near together
        order = list(batch) + sorted(
            (k for k in jobs if k not in batch),
            key=lambda k: (k[2] == 1 and k[1] == 1, k[1] == 1,
                           k[0] != "topn_pass1"))
        sys.stdout.flush()
        sys.stderr.flush()
        self.pool = multiprocessing.get_context("fork").Pool(
            HOST_WORKERS, initializer=_host_worker_init)
        self.results = {k: self.pool.apply_async(_host_job, (k,))
                        for k in order}

    def done(self) -> bool:
        return all(r.ready() for r in self.results.values())

    def get(self, key):
        """(the plain result, its tensors on the card; its seconds)."""
        out, secs = self.results[key].get()
        return _from_numpy(out), secs

    def close(self):
        self.pool.terminate()
        self.pool.join()


def event_ms(fn, reps: int, warm: bool = True) -> float:
    """Median device time of fn() in ms over ``reps`` runs, after a warm-up
    (``warm=False``: the caller has just run fn)."""
    import torch

    if warm:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def queued_ms(fn, reps: int) -> float:
    """Device ms a call of fn() with ``reps`` calls queued back to back
    between two events, after a warm-up: the card's time a call wherever
    the host queues a call faster than the card runs it."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def max_clock_hz() -> float:
    """The card's maximum SM clock, for the floor of a serial chain."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(res.stdout.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return MAX_CLOCK_HZ


# ------------------------------------------------------------------ phase 2
def kernel_cases():
    """(S, B, m) shapes: B = 1 keeps m <= 2^16 (the plain loop is slow)."""
    return [(1, 1, 4099), (8, 1, 1 << 16), (128, 1, (1 << 16) - 5),
            (1, 256, (1 << 16) + 77), (8, 256, 1 << 18),
            (128, 256, (1 << 20) + 3)]


def phase_kernels(torch, P, R, O, host):
    from repro_torch.constants import NEG
    from repro_torch.kernels import cms_sketch as C

    g = torch.Generator().manual_seed(1234)
    # (score, form) of the SKYLINE pass 1 under each seed
    sky_forms = {SEEDS[0]: (("aph", "engine"), ("sum", "kernel")),
                 SEEDS[1]: (("aph", "kernel"),)}
    for S, B, m in kernel_cases():
        x = (torch.rand(m, generator=g) * 1000).to("cuda")
        f = torch.randint(0, 20000, (m,), generator=g).to(torch.int32) \
            .view(torch.uint32).to("cuda")
        xp, _ = O._pad_to(x, S * B, float(NEG))
        fp, _ = O._pad_to(f, S * B, 0)
        pts = torch.stack([x, (f.view(torch.int32) % 1000).float()], -1)
        pp, _ = O._pad_to(pts, S * B, float(NEG))
        wi = (fp.view(torch.int32) % 1000).contiguous()
        for seed in SEEDS:
            t0 = time.perf_counter()
            k, st = P.topn_shard_states_kernel(xp, shards=S, block=B,
                                               seed=seed, **TOPN)
            k2, st2 = R.topn_block_ref(xp.reshape(S, -1), block=B, seed=seed,
                                       return_state=True, **TOPN)
            ok_t = check(same(k, k2.reshape(-1)) and same(st, st2),
                         f"topn_pass1 S={S} B={B} m={m} seed={seed}")
            merged = P.merge_topn_states(st, TOPN["w"])
            ka = P.topn_apply_kernel(xp, merged, d=TOPN["d"], shards=S,
                                     seed=seed)
            ka2 = P.topn_apply_plain(xp, merged[:, -1], d=TOPN["d"],
                                     shards=S, seed=seed)
            ok_ta = check(same(ka, ka2),
                          f"topn_apply S={S} m={m} seed={seed}")
            kd, sl, va, hd = P.distinct_shard_states_kernel(
                fp, shards=S, block=B, seed=seed, **DISTINCT)
            kd2, (sl2, va2, hd2) = R.distinct_block_ref(
                fp.reshape(S, -1), block=B, seed=seed, return_state=True,
                **DISTINCT)
            ok_d = check(same(kd, kd2.reshape(-1)) and same(sl, sl2)
                         and same(va, va2) and same(hd, hd2),
                         f"distinct_pass1 S={S} B={B} m={m} seed={seed}")
            ms, mv = P.merge_distinct_states(sl, va)
            kda = P.distinct_apply_kernel(fp, kd, ms, mv, d=DISTINCT["d"],
                                          shards=S, seed=seed)
            kda2 = P.distinct_apply_plain(fp, kd, ms, mv, d=DISTINCT["d"],
                                          shards=S, seed=seed)
            ok_da = check(same(kda, kda2),
                          f"distinct_apply S={S} m={m} seed={seed}")
            ok_s = ok_sa = True
            for score, form in sky_forms[seed]:
                ks, ps, ss = P.skyline_shard_states_kernel(
                    pp, w=SKYLINE["w"], shards=S, block=B, score=score,
                    form=form)
                ks2, (ps2, ss2) = R.skyline_block_ref(
                    pp.reshape(S, -1, 2), w=SKYLINE["w"], block=B,
                    score=score, form=form, return_state=True)
                ok_s &= check(same(ks, ks2.reshape(-1)) and same(ps, ps2)
                              and same(ss, ss2),
                              f"skyline_pass1 S={S} B={B} m={m} {score} "
                              f"{form}")
                mp, msc = P.merge_skyline_states(ps, ss)
                ok_sa &= check(same(P.skyline_apply_kernel(pp, mp, msc),
                                    P.skyline_apply_plain(pp, mp, msc)),
                               f"skyline_apply S={S} m={m} {score} {form}")
            # Count-Min: the engine's family on int32 weights and on unit
            # weights, the kernels' family on integer-valued f32 weights
            ok_c = ok_q = True
            for fam, wts in (("engine", wi), ("engine", None),
                             ("kernel", wi.float())):
                width = 4096 if fam == "kernel" else 1000 + seed
                tb = C.cms_build_kernel(fp, wts, rows=3, width=width,
                                        seed=seed, family=fam, shards=S)
                tb2 = C.cms_build_plain(fp, wts, rows=3, width=width,
                                        seed=seed, family=fam, shards=S)
                ok_c &= check(same(tb, tb2),
                              f"cms_build S={S} m={m} {fam} seed={seed}")
                for thr in (None, 50):
                    e = C.cms_query_kernel(tb[0], fp, seed=seed, family=fam,
                                           threshold=thr)
                    e2 = C.cms_query_plain(tb[0], fp, seed=seed, family=fam,
                                           threshold=thr)
                    ok_q &= check(same(e, e2), f"cms_query m={m} {fam} "
                                  f"threshold={thr} seed={seed}")
            say("kernels", S=S, B=B, m=m, seed=seed, topn_pass1=ok_t,
                topn_apply=ok_ta, distinct_pass1=ok_d, distinct_apply=ok_da,
                skyline_pass1=ok_s, skyline_apply=ok_sa, cms_build=ok_c,
                cms_query=ok_q, s=round(time.perf_counter() - t0, 3))
    phase_kernels_bloom(torch, g)
    phase_kernels_queries(torch, g)
    phase_kernels_groupby(torch, g)
    phase_kernels_ladder(torch, g)
    phase_kernels_ladder_chunks(torch, g)
    phase_kernels_rowpar(torch, g)
    phase_kernels_prefix(torch, g)
    phase_kernels_block_walk(torch, g)
    phase_kernels_topn_block(torch, g)
    phase_kernels_block_staged(torch, g)
    phase_kernels_distinct_apply(torch, g)
    phase_kernels_topn_apply(torch, g)
    phase_kernels_a27(torch, P, R, O, host)


# the Count-Min tables of the query cases: (rows, width); the first four
# fit a CTA's shared memory (the staged query), the last three do not
QUERY_TABLES = ((3, 4096), (3, 1000), (5, 64), (3, 1 << 14), (4, 1 << 14),
                (2, 40000), (3, 1 << 16))
QUERY_MS = (1, 3, 4097, (1 << 20) + 3)
QUERY_VIEWS = (0, 1, 3)        # entries into their storage the keys start
# the Bloom filters of the query cases: (nbits, family); 600001 and 2^24
# bits are above the staged query's 48 KB
QUERY_FILTERS = ((1 << 15, "kernel"), (1000, "kernel"), (40000, "kernel"),
                 (12345, "engine"), (600001, "engine"), (1 << 24, "engine"))


def same_out(a, b) -> bool:
    """same_bits, a float16 output by its f32 values (every NaN as one)."""
    import torch

    if a.dtype == b.dtype == torch.float16:
        a, b = a.float(), b.float()
    return same_bits(a, b)


def query_keys(torch, g, m, off, dtype):
    """m random 32-bit keys of ``dtype`` on the card, as a view ``off``
    entries into their storage (``view_at``)."""
    k = torch.randint(-(1 << 31), 1 << 31, (m,), generator=g,
                      dtype=torch.int64).to(torch.int32).cuda()
    return view_at(torch, k, off).view(dtype) if off else k.view(dtype)


def odd_table(torch, g, rows, width, kind):
    """An f32 table of small integer counters: "finite"; "specials", NaN,
    +-inf, -0, FLT_MAX and subnormals dropped in; "nan row 1", a NaN
    counter below row 0 (A24); "-0" and "max", the whole table of -0 or
    FLT_MAX (A21, A22)."""
    t = torch.randint(0, 50, (rows, width), generator=g).float()
    if kind == "specials":
        for v in (float("nan"), float("inf"), -float("inf"), -0.0,
                  float(torch.finfo(torch.float32).max), 1e-40, -1e-40):
            t[int(torch.randint(rows, (1,), generator=g)),
              int(torch.randint(width, (1,), generator=g))] = v
    elif kind == "nan row 1":
        t[min(1, rows - 1), int(torch.randint(width, (1,), generator=g))] = \
            float("nan")
    elif kind == "-0":
        t[:] = -0.0
    elif kind == "max":
        t[:] = float(torch.finfo(torch.float32).max)
    return t.cuda()


def phase_kernels_queries(torch, g):
    """The persistent Count-Min and Bloom queries against their plain
    versions, bit for bit (every NaN as one): every table dtype (f32, int32,
    uint32, f16, int8), both hash families (the kernels' on uint32 and on
    int32 keys), no threshold and an int and a float one, tables on both
    sides of the shared-memory route (QUERY_TABLES: power-of-two widths,
    which the query reduces with a shift or a mask, and others), m = 0, 1,
    3, 4097 and 2^20 + 3, keys as views 0, 1 and 3 entries into their
    storage; tables with NaN, +-inf, -0, FLT_MAX and subnormal counters in
    both families (A21, A22, and A24: a NaN below row 0); the Bloom query
    on each route (QUERY_FILTERS), 1, 3 and 5 hashes, and on f32 bit
    vectors with a NaN, an inf, a -inf or two infinities (A23), in both
    families."""
    from repro_torch.kernels import bloom_filter as B
    from repro_torch.kernels import cms_sketch as C
    from repro_torch.kernels.common import (F32, I32, I64, P as VP, U32,
                                            grid_for, ptr)

    dev = torch.device("cuda", torch.cuda.current_device())
    for rows, width in QUERY_TABLES:
        t0 = time.perf_counter()
        ok = True
        for dt in (torch.float32, torch.int32, torch.uint32, torch.float16,
                   torch.int8):
            base = torch.randint(0, 50, (rows, width), generator=g).cuda()
            tab = base.to(torch.int32).view(torch.uint32) \
                if dt == torch.uint32 else base.to(dt)
            for fam in ("kernel", "engine"):
                for thr in (None, 20, 20.5):
                    if thr == 20.5 and not dt.is_floating_point:
                        continue
                    for m in (0,) + QUERY_MS:
                        for off in QUERY_VIEWS:
                            kd = torch.int32 if off == 1 else torch.uint32
                            k = query_keys(torch, g, m, off, kd)
                            kw = dict(seed=m + off, family=fam,
                                      threshold=thr)
                            ok &= check(same_out(
                                C.cms_query_kernel(tab, k, **kw),
                                C.cms_query_plain(tab, k, **kw)),
                                f"cms_query {rows}x{width} {dt} {fam} "
                                f"threshold={thr} m={m} view={off} "
                                f"keys={kd}")
        staged = C.query_plan(dev, rows, width, 0, 1)[0]
        say("kernels", cms_query=ok, rows=rows, width=width,
            route="staged" if staged else "global",
            s=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    ok = True
    for rows, width in ((3, 4096), (1, 64), (2, 40000)):
        for kind in ("specials", "nan row 1", "-0", "max"):
            tab = odd_table(torch, g, rows, width, kind)
            for fam in ("kernel", "engine"):
                for thr in (None, 20.5, 0.0):
                    for m in QUERY_MS[2:]:
                        for off in QUERY_VIEWS:
                            kd = torch.int32 if off == 1 else torch.uint32
                            k = query_keys(torch, g, m, off, kd)
                            kw = dict(seed=off, family=fam, threshold=thr)
                            ok &= check(same_out(
                                C.cms_query_kernel(tab, k, **kw),
                                C.cms_query_plain(tab, k, **kw)),
                                f"cms_query {kind} {rows}x{width} {fam} "
                                f"threshold={thr} m={m} view={off}")
    say("kernels", cms_query_odd_tables=ok,
        s=round(time.perf_counter() - t0, 3))
    # A24 on its smallest table: a NaN row below row 0. The retired query
    # (cms_query_grid) folded from row 0 with < and so read the row 0
    # counter; the persistent query takes the NaN, as the plain version
    tab = torch.ones(3, 4096, device="cuda")
    tab[1] = float("nan")
    k = query_keys(torch, g, 4097, 0, torch.uint32)
    for fam in ("kernel", "engine"):
        new = C.cms_query_kernel(tab, k, family=fam, threshold=0.5)
        plain = C.cms_query_plain(tab, k, family=fam, threshold=0.5)
        old = torch.empty_like(new)
        serial_kernel(torch, "cms_query_grid", [VP] * 4 + [
            I64, I32, I32, U32, I32, I32, I64, F32, I32], ptr(tab),
            ptr(k), None, ptr(old), k.numel(), 3, 4096, 0,
            C._family(fam, k), 0, 0, 0.5, grid_for(k.numel(), k.device))
        check(same(new, plain), f"cms_query A24 {fam}: a NaN below row 0")
        say("kernels", a24=fam, kept_plain=int(plain.sum()),
            kept_persistent=int(new.sum()), kept_retired=int(old.sum()))
    for nbits, fam in QUERY_FILTERS:
        t0 = time.perf_counter()
        ok = True
        for H in (1, 3, 5):
            src = query_keys(torch, g, 1 << 14, 0, torch.int32)
            kw = dict(nbits=nbits, num_hashes=H, seed=H, family=fam)
            words = B.bloom_build_plain(src, **kw)
            bits = B.unpack_bits(words, nbits).float()
            for case in ("finite", "inf", "nan", "-inf", "two"):
                info, w = None, words
                if case != "finite":
                    b = bits.clone()
                    p = int(torch.randint(nbits, (1,), generator=g))
                    b[p] = {"inf": float("inf"), "nan": float("nan"),
                            "-inf": -float("inf"),
                            "two": float("inf")}[case]
                    if case == "two":
                        b[(p + 5) % nbits] = -float("inf")
                    w, info = B.pack_bits(b > 0.5), B.nonfinite_bits(b)
                for m in (0,) + QUERY_MS:
                    for off in QUERY_VIEWS:
                        kd = torch.int32 if off == 1 else torch.uint32
                        k = query_keys(torch, g, m, off, kd)
                        n = min(m // 2, src.numel())
                        k[:n] = src[:n].view(kd)  # members
                        ok &= check(same(
                            B.bloom_query_kernel(w, k, nonfinite=info, **kw),
                            B.bloom_query_plain(w, k, nonfinite=info, **kw)),
                            f"bloom_query nbits={nbits} {fam} H={H} {case} "
                            f"m={m} view={off} keys={kd}")
        staged = B.query_plan(dev, nbits, 3, 1)[0]
        say("kernels", bloom_query=ok, nbits=nbits, family=fam,
            route="staged" if staged else "global",
            s=round(time.perf_counter() - t0, 3))


def phase_kernels_bloom(torch, g):
    """Both Bloom kernels against their plain versions: both hash families
    on both sides of 2^16 bits, with and without a mask, ragged m."""
    from repro_torch.kernels import bloom_filter as B

    for m in (4099, (1 << 16) + 77, (1 << 20) + 3):
        t0 = time.perf_counter()
        keys = torch.randint(-(1 << 31), 1 << 31, (m,), generator=g,
                             dtype=torch.int64).to(torch.int32).cuda()
        mask = (torch.rand(m, generator=g) < 0.5).cuda()
        probe = torch.cat([keys[: m // 2], torch.randint(
            0, 1 << 30, (m - m // 2,), generator=g).to(torch.int32).cuda()])
        ok_b = ok_q = True
        for fam, nbits, msk in (("kernel", 1000, None),
                                ("kernel", BLOOM_OPS["nbits"], None),
                                ("engine", 12345, mask),
                                ("engine", JOIN["nbits"], None),
                                ("engine", JOIN["nbits"], mask)):
            kw = dict(nbits=nbits, num_hashes=3, seed=m, family=fam)
            w = B.bloom_build_kernel(keys, mask=msk, **kw)
            ok_b &= check(same(w, B.bloom_build_plain(keys, mask=msk, **kw)),
                          f"bloom_build m={m} {fam} nbits={nbits} "
                          f"mask={msk is not None}")
            ok_q &= check(same(B.bloom_query_kernel(w, probe, **kw),
                               B.bloom_query_plain(w, probe, **kw)),
                          f"bloom_query m={m} {fam} nbits={nbits}")
        say("kernels", m=m, bloom_build=ok_b, bloom_query=ok_q,
            s=round(time.perf_counter() - t0, 3))
    # the cluster build (filters above 48 KB) by its C entry, whatever the
    # wrapper's route, and the wrapper: JOIN F_A's shape with and without a
    # mask, an nbits that is not a multiple of 32 * K, a filter that takes
    # clusters of 2, m smaller than a cluster's CTAs, and m = 0
    t0 = time.perf_counter()
    keys = torch.randint(0, M_MAIN // 5, (M_MAIN,), generator=g).to(
        torch.int32).cuda()
    mask = (torch.rand(M_MAIN, generator=g) < 0.5).cuda()
    ok_c = True
    for name, k, msk, nbits in (
            ("F_A", keys, None, JOIN["nbits"]),
            ("F_A masked", keys, mask, JOIN["nbits"]),
            ("nbits 2^24 - 37", keys[:(1 << 20) + 3], None,
             JOIN["nbits"] - 37),
            ("nbits 600001", keys[:99991], mask[:99991], 600001),
            ("m = 7", keys[:7], None, JOIN["nbits"]),
            ("m = 0", keys[:0], None, JOIN["nbits"])):
        kw = dict(nbits=nbits, num_hashes=3, seed=nbits, family="engine")
        want = B.bloom_build_plain(k, mask=msk, **kw)
        w = torch.empty_like(want)
        bloom_cluster(torch, k, w, kw, msk)
        K = bloom_plan_k(torch, nbits, 3)
        route = B.bloom_route(nbits, 3, k.numel(), K)
        counter = B.BLOOM_BUILD if route == "cluster" else \
            B.BLOOM_BUILD_GLOBAL
        before = counter.launches
        ok_c &= check(
            same(w, want) and same(B.bloom_build_kernel(k, mask=msk, **kw),
                                   want)
            and counter.launches == before + (k.numel() > 0),
            f"bloom_build cluster {name} m={k.numel()} nbits={nbits} K={K} "
            f"route={route}")
    say("kernels", bloom_build_cluster=ok_c,
        s=round(time.perf_counter() - t0, 3))


def phase_kernels_groupby(torch, g):
    """The GROUP BY scan against its plain version at S in {1, 8, 128}, all
    four aggregates, on ragged m padded as the engine pads (a validity
    column, False on the pads and on a tenth of the real entries)."""
    from repro_torch.kernels import groupby_scan as G
    from repro_torch.kernels import ops as O

    for S, m in ((1, 4099), (8, (1 << 15) + 3), (128, (1 << 16) - 5)):
        t0 = time.perf_counter()
        keys = torch.randint(0, 20000, (m,), generator=g).to(torch.int32) \
            .view(torch.uint32).cuda()
        vals = (torch.randn(m, generator=g) * 100).cuda()
        valid = (torch.rand(m, generator=g) < 0.9).cuda()
        kp, _ = O._pad_to(keys, S, 0)
        vp, _ = O._pad_to(vals, S, 0.0)
        okp, _ = O._pad_to(valid, S, False)
        n = kp.shape[0] // S
        res = {}
        for agg in G.AGGS:
            for v in (None, okp):
                if v is None and S > 1:
                    continue  # the engine always pads with a validity column
                ev, st = G.groupby_pass1_kernel(kp, vp, v, agg=agg, shards=S,
                                                seed=S, **GROUPBY)
                ev2, st2 = G.groupby_pass1_plain(
                    kp.view(S, n), vp.view(S, n),
                    None if v is None else v.view(S, n), agg=agg, seed=S,
                    **GROUPBY)
                res[agg] = check(
                    all(same(a, b.reshape(-1)) for a, b in zip(ev, ev2))
                    and all(same(a, b) for a, b in zip(st, st2)),
                    f"groupby_pass1 S={S} m={m} {agg} "
                    f"valid={v is not None}") and res.get(agg, True)
        say("kernels", S=S, m=m, groupby_pass1=json.dumps(res),
            s=round(time.perf_counter() - t0, 3))


def phase_kernels_ladder(torch, g):
    """The topn_det ladder scan and LRU DISTINCT at S in {1, 8, 128} on
    ragged m padded as the engine pads, and the RLE run scan on ragged
    layouts, each against its plain version on the card."""
    from repro_torch.constants import NEG
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rle_scan as RS
    from repro_torch.kernels import topn_det_scan as TD

    for S, m in ((1, 4099), (8, (1 << 15) + 3), (128, (1 << 16) - 5)):
        t0 = time.perf_counter()
        x = (torch.rand(m, generator=g) * 1000).cuda()
        ok_t = ok_l = True
        for sign, v in (("pos", x), ("neg", x - 700.0)):
            vp, _ = O._pad_to(v, S, float(NEG))
            n = vp.shape[0] // S
            for N, w in ((100, 8), (n + 7, 4), (250, 4)):  # n + 7: N > shard
                k, st = TD.topn_det_pass1_kernel(vp, N=N, w=w, shards=S)
                k2, st2 = TD.topn_det_pass1_plain(vp.view(S, n), N=N, w=w)
                ok_t &= check(same(k, k2.reshape(-1)) and all(
                    same(a, b) for a, b in zip(st, st2)),
                    f"topn_det_pass1 S={S} m={m} {sign} N={N} w={w}")
        # (d, w, universe): the engine's cache, and small caches whose rows
        # fill, so that hits land at every slot
        for d, w, U in ((DISTINCT["d"], DISTINCT["w"], 20000), (16, 4, 60),
                        (64, 8, 700)):
            f = torch.randint(0, U, (m,), generator=g).to(torch.int32) \
                .view(torch.uint32).cuda()
            fp, _ = O._pad_to(f, S, 0)
            out = P.distinct_shard_states_kernel(fp, d=d, w=w, shards=S,
                                                 block=1, seed=S,
                                                 policy="lru")
            k2, st2 = R.distinct_lru_ref(fp.view(S, -1), d=d, w=w, seed=S,
                                         return_state=True)
            ok_l &= check(same(out[0], k2.reshape(-1)) and all(
                same(a, b) for a, b in zip(out[1:], st2)),
                f"distinct_pass1_lru S={S} m={m} d={d} w={w} U={U}")
        say("kernels", S=S, m=m, topn_det_pass1=ok_t, distinct_pass1_lru=ok_l,
            s=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    ok_r = True
    for name, v, L, N, w, expand in rle_kernel_layouts(torch, g):
        for block in (64, 256):
            h, t = O.rle_topn_prune(v, L, N=N, w=w, block=block)
            h2, t2 = RS.rle_topn_det_ref(v, L, N=N, w=w)
            ok = same(h, h2) and same(t, t2)
            if expand:
                flat = TD.topn_det_pass1_plain(
                    torch.repeat_interleave(v, L)[None], N=N, w=w)[0][0]
                ok &= same(O.rle_expand_mask(h, t, L, int(L.sum())), flat)
            ok_r &= check(ok, f"rle_topn_det {name} R={v.numel()} N={N} "
                          f"w={w} block={block}")
    say("kernels", rle_topn_det=ok_r, s=round(time.perf_counter() - t0, 3))


def rle_kernel_layouts(torch, g):
    """(name, f32 run values, int32 lengths, N, w, whether the expanded
    column is also checked) of the RLE run scan's cases, on the card: R from
    1 run to several chunks of RLE_CHUNK; NaN of both signs, +-0, +-inf and
    values near FLT_MAX; zero-length runs inside the column; a warm-up that
    ends at a chunk boundary and one that ends mid-chunk; and the wrap, a
    few runs of 2^30 that take seen past 2^31 so that later runs are warm
    again (ROADMAP Queue 3 A10; head and tstar only, the column has 2^33
    rows). The layouts with NaN runs and zero-length runs are not held to
    the flat scan of their expanded column: there the reference's closed
    form keeps rows that the flat scan drops (ROADMAP Queue 3 B7)."""
    out = []
    for name, R_, N, w in (("ragged", 1037, 250, 8), ("one run", 1, 16, 4),
                           ("all distinct", 4101, 100, 8),
                           ("negative", 777, 300, 4),
                           ("N above the rows", 300, 1 << 20, 8),
                           ("several chunks, w=32", 5 * RLE_CHUNK + 256, 900,
                            32)):
        L = torch.randint(1, 100, (R_,), generator=g).to(torch.int32)
        v = torch.rand(R_, generator=g) * 100
        if name == "negative":
            v = v - 50.0
        if name == "all distinct":
            v = torch.arange(1, R_ + 1, dtype=torch.float32)
            L = torch.ones_like(L)
        out.append((name, v, L, N, w, True))
    R_ = 3 * RLE_CHUNK + 100
    pool = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                         -float("inf"), 3.4028234663852886e38, 3.0e38,
                         -3.4028234663852886e38])
    v = torch.rand(R_, generator=g) * 100
    at = torch.rand(R_, generator=g) < 0.2
    v[at] = pool[torch.randint(0, pool.numel(), (int(at.sum()),),
                               generator=g)]
    nan_neg = (torch.rand(R_, generator=g) < 0.02) & at
    v = torch.where(nan_neg, torch.tensor([NEG_NAN_BITS], dtype=torch.int32)
                    .view(torch.float32), v)
    L = torch.randint(1, 40, (R_,), generator=g).to(torch.int32)
    out.append(("nan of both signs, +-0, +-inf, near FLT_MAX", v, L, 2000, 8,
                False))
    L0 = L.clone()
    L0[torch.rand(R_, generator=g) < 0.25] = 0
    out.append(("zero-length runs", torch.rand(R_, generator=g) * 100, L0,
                3000, 8, False))
    ones = torch.ones(R_, dtype=torch.int32)
    r = torch.rand(R_, generator=g) * 100
    for label, N in (("at a chunk boundary", RLE_CHUNK),
                     ("at the second chunk boundary", 2 * RLE_CHUNK),
                     ("mid-chunk", RLE_CHUNK + 1000)):
        out.append((f"warm-up ends {label}", r, ones, N, 8, True))
    L = torch.randint(0, 50, (2 * RLE_CHUNK + 300,), generator=g).to(
        torch.int32)
    L[[5, 6, 7, 2100, 2101, 2102, 2103, 4000]] = 1 << 30
    out.append(("wrap", torch.rand(L.numel(), generator=g) * 100, L, 1000, 8,
                False))
    return [(n, v.cuda(), L.cuda(), N, w, e) for n, v, L, N, w, e in out]


def ladder_streams(torch, g, S, n):
    """The streams the chunked ladder is held to, S lanes of n entries on
    the card: ascending (every level fills), all equal, a NaN in the
    warm-up and one after it, +-inf, -0 and negatives, and values near
    FLT_MAX (t0 stays POS and the levels above it overflow to inf)."""
    m = S * n
    r = torch.rand(m, generator=g) * 1000
    t = {"ascending": torch.arange(1, n + 1, dtype=torch.float32).repeat(S),
         "all equal": torch.full((m,), 3.0), "random": r}
    for name, at in (("nan in the warm-up", 50), ("nan after it", n - 9)):
        v = r.clone().view(S, n)
        v[:, at] = float("nan")
        t[name] = v.reshape(m)
    odd = torch.tensor([float("inf"), -float("inf"), -0.0, 0.0, -5.0])
    v = r - 500.0
    v[::7] = odd[torch.randint(0, odd.numel(), (v[::7].numel(),),
                               generator=g)]
    t["inf, -0, negatives"] = v
    big = torch.rand(m, generator=g) * 2.4e38 + 1e38
    big[::5] = 3.4028234663852886e38  # FLT_MAX
    t["near FLT_MAX"] = big
    return {k: v.cuda() for k, v in t.items()}


def phase_kernels_ladder_chunks(torch, g):
    """The chunked ladder against its plain version on adversarial streams
    (ladder_streams) at S = 1, 8 and 128 lanes that span one to four
    chunks, N inside the first chunk, at a chunk boundary and +-1 and past
    the shard, w in {1, 8, 32}: keep and final state bit for bit
    (same_bits: every NaN as one)."""
    from repro_torch.kernels import topn_det_scan as TD

    for S, n in LADDER_LANE.items():
        t0 = time.perf_counter()
        ok = True
        for name, x in ladder_streams(torch, g, S, n).items():
            for N in LADDER_NS:
                N = n + 7 if N == "n + 7" else N
                for w in LADDER_WS:
                    k, st = TD.topn_det_pass1_kernel(x, N=N, w=w, shards=S)
                    k2, st2 = TD.topn_det_pass1_plain(x.view(S, n), N=N, w=w)
                    ok &= check(same(k, k2.reshape(-1)) and all(
                        same_bits(a, b) for a, b in zip(st, st2)),
                        f"topn_det_pass1 chunks S={S} {name} N={N} w={w}")
        say("kernels", S=S, n=n, topn_det_chunks=ok,
            s=round(time.perf_counter() - t0, 3))


def block_walk_streams(torch, g, m):
    """The streams of the DISTINCT block walk's cases, on the card:
    uniform keys, zipf(1.3) keys, a small universe (60 keys, so that rows
    fill and hits land at every slot) and float32 values (the JAX
    package's conversions to uint32 slots)."""
    z = (torch.rand(m, generator=g).clamp(min=1e-9) ** (-1 / 0.3)).floor()
    out = {"uniform": torch.randint(0, 20000, (m,), generator=g),
           "zipf": z.clamp(max=2 ** 30).long() % 5000,
           "small universe": torch.randint(0, 60, (m,), generator=g)}
    out = {k: v.to(torch.int32).view(torch.uint32).cuda()
           for k, v in out.items()}
    floats = torch.tensor(FLOAT_KEYS)[torch.randint(
        0, len(FLOAT_KEYS), (m,), generator=g)]
    floats[::3] = torch.randint(0, 6, (floats[::3].numel(),),
                                generator=g).float()
    out["float32"] = floats.cuda()
    return out


def phase_kernels_block_walk(torch, g):
    """Both B > 1 forms of DISTINCT's pass 1, the block walk
    (distinct_block_walk_kernel, the form ops.distinct_prune takes) and the
    staged block kernel (by its C entry, whatever the dispatch picks),
    against ref.distinct_block_ref at B in BLOCK_WALK_BS and S = 1, 8 and
    128, on the streams of block_walk_streams, and the walk on the trap
    stream BLOCK_TRAP: keep, slots, valid and head bit for bit. The plain
    versions run on the host (on_host)."""
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import ref as R

    for S, n in BLOCK_WALK_LANE.items():
        t0 = time.perf_counter()
        xs = block_walk_streams(torch, g, S * n)
        ok = ok_b = True
        for name, d, w in BLOCK_WALK_CASES:
            x = xs[name]
            for B in BLOCK_WALK_BS:
                out = P.distinct_block_walk_kernel(x, d=d, w=w, shards=S,
                                                   block=B, seed=S)
                (k2, st2), _ = on_host(lambda u: R.distinct_block_ref(
                    u, d=d, w=w, block=B, seed=S, return_state=True),
                    x.view(S, n))
                want = (k2.reshape(-1),) + tuple(st2)
                ok &= check(all(same(a, b) for a, b in zip(out, want)),
                            f"distinct block walk S={S} B={B} {name} d={d} "
                            f"w={w}")
                out = distinct_block_kernel(torch, x, S, d, w, B, S)
                ok_b &= check(all(same(a, b) for a, b in zip(out, want)),
                              f"distinct block kernel S={S} B={B} {name} "
                              f"d={d} w={w}")
        say("kernels", S=S, n=n, distinct_block_walk=ok,
            distinct_block_kernel=ok_b, s=round(time.perf_counter() - t0, 3))
    x = torch.tensor(BLOCK_TRAP[0], dtype=torch.int32).view(
        torch.uint32).cuda()
    out = P.distinct_block_walk_kernel(x, d=1, w=1, shards=1, block=2)
    k2, st2 = R.distinct_block_ref(x, d=1, w=1, block=2, return_state=True)
    ok = check(out[0].tolist() == list(BLOCK_TRAP[1])
               and same(out[0], k2) and all(
                   same(a[0], b) for a, b in zip(out[1:], st2)),
               f"distinct block walk on the trap stream {BLOCK_TRAP[0]}")
    say("kernels", distinct_block_walk_trap=ok, keep=json.dumps(
        out[0].tolist()))


def topn_block_streams(torch, g, S, n, B):
    """The streams the TOP-N block forms are held to, S lanes of n entries
    on the card: random, ascending (every group inserts), all equal, -0 and
    +0 mixed inside each block, a negative and a positive NaN mid-block
    beside a value that beats the row minimum, NaNs at a block boundary,
    and values at, just below and just above NEG (and -inf)."""
    from repro_torch.constants import NEG

    m = S * n
    r = torch.rand(m, generator=g) * 1000
    nneg = torch.tensor([NEG_NAN_BITS], dtype=torch.int32).view(torch.float32)
    zero = torch.tensor([0.0, -0.0, -1.0])
    t = {"random": r, "ascending": torch.arange(m, dtype=torch.float32),
         "all equal": torch.full((m,), 3.0),
         "zeros": zero[torch.randint(0, 3, (m,), generator=g)]}
    v = r.clone()
    mid = torch.arange(0, m, 3 * B) + B // 2
    v[mid - 1], v[mid], v[(mid + 1) % m] = 5000.0, nneg, float("nan")
    t["nan mid-block"] = v
    v = r.clone()
    v[B - 1::4 * B], v[B::4 * B] = nneg, float("nan")
    t["nan at a block boundary"] = v
    neg = torch.tensor(float(NEG))
    low = torch.stack([neg, torch.nextafter(neg, torch.tensor(-float("inf"))),
                       torch.nextafter(neg, torch.tensor(0.0)),
                       torch.tensor(-float("inf"))])
    v = r.clone()
    v[::2] = low[torch.randint(0, 4, (v[::2].numel(),), generator=g)]
    t["low"] = v
    return {k: v.cuda() for k, v in t.items()}


def topn_block_kernel(torch, x, S, d, w, B, seed, entry="topn_pass1"):
    """The one-CTA-a-lane block kernel by its C entry, whatever the dispatch
    would pick: topn_pass1 at B > 1 (the staged kernel) or
    topn_pass1_block_unstaged (the kernel it replaced): (keep, states)."""
    from repro_torch.kernels.common import I32, P as VP, U32, ptr

    m = x.numel()
    keep = torch.empty(m, dtype=torch.bool, device="cuda")
    st = torch.empty((S, d, w), dtype=torch.float32, device="cuda")
    args = (ptr(x), ptr(keep), ptr(st), S, m // S, d, w, B, seed)
    if entry == "topn_pass1":
        serial_kernel(torch, entry, [VP] * 3 + [I32] * 5 + [U32, VP, VP, U32,
                                                             I32],
                      *args, None, None, 0, 0)
    else:
        serial_kernel(torch, entry, [VP] * 3 + [I32] * 5 + [U32], *args)
    return keep, st


def distinct_block_kernel(torch, x, S, d, w, B, seed,
                          entry="distinct_pass1"):
    """DISTINCT's one-CTA-a-lane block kernel by its C entry, whatever the
    dispatch would pick: distinct_pass1 at B > 1 (the staged kernel) or
    distinct_pass1_block_unstaged: (keep, slots, valid, head)."""
    from repro_torch.kernels.common import I32, P as VP, U32, ptr

    m = x.numel()
    out = (torch.empty(m, dtype=torch.bool, device="cuda"),
           torch.empty((S, d, w), dtype=torch.uint32, device="cuda"),
           torch.empty((S, d, w), dtype=torch.bool, device="cuda"),
           torch.empty((S, d), dtype=torch.int32, device="cuda"))
    fmode = int(x.dtype == torch.float32)
    ptrs = [ptr(t) for t in (x,) + out]
    if entry == "distinct_pass1":
        serial_kernel(torch, entry, [VP] * 5 + [I32] * 7 + [U32, VP, I32],
                      *ptrs, S, m // S, d, w, B, 0, fmode, seed, None, 0)
    else:
        serial_kernel(torch, entry, [VP] * 5 + [I32] * 6 + [U32], *ptrs, S,
                      m // S, d, w, B, fmode, seed)
    return out


def phase_kernels_topn_block(torch, g):
    """Both B > 1 forms of TOP-N's pass 1, the row-parallel block walk and
    the block kernel (whatever the dispatch picks), against
    ref.topn_block_ref at B in BLOCK_WALK_BS, (d, w) in TOPN_BLOCK_SHAPES
    and S = 1, 8 and 128, on the streams of topn_block_streams: keep and
    final state bit for bit (same_bits). The plain versions run on the
    host (on_host)."""
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import ref as R

    for S, n in BLOCK_WALK_LANE.items():
        t0 = time.perf_counter()
        ok_w = ok_b = True
        for B in BLOCK_WALK_BS:
            for name, x in topn_block_streams(torch, g, S, n, B).items():
                for d, w in TOPN_BLOCK_SHAPES:
                    (k2, st2), _ = on_host(lambda u: R.topn_block_ref(
                        u, d=d, w=w, block=B, seed=S, return_state=True),
                        x.view(S, n))
                    k2 = k2.reshape(-1)
                    k, st = P.topn_block_walk_kernel(x, d=d, w=w, shards=S,
                                                     block=B, seed=S)
                    ok_w &= check(same_bits(k, k2) and same_bits(st, st2),
                                  f"topn block walk S={S} B={B} {name} "
                                  f"d={d} w={w}")
                    k, st = topn_block_kernel(torch, x, S, d, w, B, S)
                    ok_b &= check(same_bits(k, k2) and same_bits(st, st2),
                                  f"topn block kernel S={S} B={B} {name} "
                                  f"d={d} w={w}")
        say("kernels", S=S, n=n, topn_block_walk=ok_w, topn_block_kernel=ok_b,
            s=round(time.perf_counter() - t0, 3))


def staged_streams(torch, g, S, n):
    """The streams the staged block kernels are held to, S lanes of n
    entries on the card, (name, TOP-N values, DISTINCT keys): the main
    path's columns (a uservisits table of S * n rows: ad_revenue and
    source_ip); a stream on which every entry inserts or misses (ascending
    values, all-distinct keys); all-equal values among +-0 and NaNs of
    both signs, and float32 DISTINCT keys (FLOAT_KEYS)."""
    from repro_torch.query import make_uservisits

    m = S * n
    uv = make_uservisits(m, seed=S + n, device="cuda")
    pick = torch.tensor([3.0, 3.0, 3.0, 0.0, -0.0, float("nan"), 0.0])
    pick[-1:] = torch.tensor([NEG_NAN_BITS], dtype=torch.int32).view(
        torch.float32)
    floats = torch.tensor(FLOAT_KEYS)[torch.randint(
        0, len(FLOAT_KEYS), (m,), generator=g)]
    floats[::3] = torch.randint(0, 6, (floats[::3].numel(),),
                                generator=g).float()
    return (("main-path columns", uv.cols["ad_revenue"],
             uv.cols["source_ip"]),
            ("every entry inserts", torch.arange(m, dtype=torch.float32)
             .cuda(), torch.arange(m, dtype=torch.int32).view(torch.uint32)
             .cuda()),
            ("all equal, +-0 and NaNs / float32 keys",
             pick[torch.randint(0, len(pick), (m,), generator=g)].cuda(),
             floats.cuda()))


def view_at(torch, x, off):
    """A copy of x as the view [off : off + len(x)] of a longer tensor: a
    stream that starts off entries (4 * off bytes) into its storage."""
    big = torch.zeros(x.numel() + 8, dtype=x.dtype, device=x.device)
    big[off:off + x.numel()] = x
    return big[off:off + x.numel()]


def phase_kernels_block_staged(torch, g):
    """The staged block kernels (topn_pass1_block, distinct_pass1_block) by
    their C entries, and pass 1 as dispatched (topn_shard_states_kernel,
    distinct_shard_states_kernel), against ref.topn_block_ref and
    ref.distinct_block_ref at B = 256, S in STAGED_LANES: keep and every
    lane's state bit for bit, on the streams of staged_streams, at the
    (d, w) of STAGED_TOPN and STAGED_DISTINCT (d = 1, w = 64 for TOP-N), on
    lanes of one chunk and of STAGED_CHUNKS chunks (not a whole number of
    stages), and on the main-path columns as views starting 1 and 3
    entries into their storage. The plain versions run on the host."""
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import ref as R

    B = 256
    for S in STAGED_LANES:
        for n in (B, B * STAGED_CHUNKS):
            t0 = time.perf_counter()
            ok_t = ok_d = True
            streams = staged_streams(torch, g, S, n)
            cases = [(name, 0, v, f) for name, v, f in streams]
            cases += [(streams[0][0], off, view_at(torch, streams[0][1], off),
                       view_at(torch, streams[0][2], off)) for off in (1, 3)]
            for name, off, v, f in cases:
                what = f"S={S} n={n} {name}" + (f" at x[{off}:]" if off
                                                  else "")
                for d, w in STAGED_TOPN if not off else STAGED_TOPN[:1]:
                    (k2, st2), _ = on_host(lambda u: R.topn_block_ref(
                        u, d=d, w=w, block=B, seed=S, return_state=True),
                        v.view(S, n))
                    k2 = k2.reshape(-1)
                    for form, (k, st) in (
                            ("C entry", topn_block_kernel(torch, v, S, d, w,
                                                          B, S)),
                            ("dispatched", P.topn_shard_states_kernel(
                                v, d=d, w=w, shards=S, block=B, seed=S))):
                        ok_t &= check(same_bits(k, k2) and same_bits(st, st2),
                                      f"topn_pass1_block {form} {what} d={d} "
                                      f"w={w}")
                for d, w in STAGED_DISTINCT if not off else \
                        STAGED_DISTINCT[:1]:
                    (k2, st2), _ = on_host(lambda u: R.distinct_block_ref(
                        u, d=d, w=w, block=B, seed=S, return_state=True),
                        f.view(S, n))
                    want = (k2.reshape(-1),) + tuple(st2)
                    for form, out in (
                            ("C entry", distinct_block_kernel(
                                torch, f, S, d, w, B, S)),
                            ("dispatched", P.distinct_shard_states_kernel(
                                f, d=d, w=w, shards=S, block=B, seed=S))):
                        ok_d &= check(all(same(a, b) for a, b in zip(
                            out, want)), f"distinct_pass1_block {form} {what} "
                            f"d={d} w={w}")
            say("kernels", S=S, n=n, block=B,
                dispatched=json.dumps("block walk" if P.use_block_walk(
                    S, torch.device("cuda")) else "block kernel"),
                topn_pass1_block=ok_t, distinct_pass1_block=ok_d,
                s=round(time.perf_counter() - t0, 3))


def distinct_apply_streams(torch, g, S, n):
    """The streams of distinct_apply's cases, on the card: a key in 90 % of
    every lane (every shard caches it, so the lowest owner is shard 0), a
    key that only the top lane holds (its owner is its own lane), and
    float32 values (FLOAT_KEYS: negatives, NaN, +-inf, non-integers and
    values past 2^32 cannot hit)."""
    m = S * n
    hot = torch.randint(0, 300, (m,), generator=g)
    hot[torch.rand(m, generator=g) < 0.9] = 7
    top = torch.randint(0, 40, (m,), generator=g)
    last = torch.arange(m) >= m - n
    top[last & (torch.rand(m, generator=g) < 0.5)] = 123456
    floats = torch.tensor(FLOAT_KEYS)[torch.randint(
        0, len(FLOAT_KEYS), (m,), generator=g)]
    floats[::3] = torch.randint(0, 6, (floats[::3].numel(),),
                                generator=g).float()
    out = {k: v.to(torch.int32).view(torch.uint32).cuda()
           for k, v in (("hot key", hot), ("top lane only", top))}
    out["float32"] = floats.cuda()
    return out


def phase_kernels_distinct_apply(torch, g):
    """The lowest-owner distinct_apply against distinct_apply_plain at
    S = 1, 8 and 128 and w in DISTINCT_APPLY_WS, on the streams of
    distinct_apply_streams, after the FIFO pass 1 (B = 1) on the card:
    keep bit for bit; then at each lane base of MESH_POSITIONS positions
    (the resident pass 2's sub-ranges), each against its plain run and all
    against the whole apply. The plain versions run on the host
    (on_host)."""
    from repro_torch.kernels import parallel as P

    d = 37
    for S, n in DISTINCT_APPLY_LANE.items():
        t0 = time.perf_counter()
        ok = True
        for name, x in distinct_apply_streams(torch, g, S, n).items():
            for w in DISTINCT_APPLY_WS[S]:
                keep1, sl, va, _ = P.distinct_shard_states_kernel(
                    x, d=d, w=w, shards=S, block=1, seed=S)
                ms, mv = P.merge_distinct_states(sl, va)
                k = P.distinct_apply_kernel(x, keep1, ms, mv, d=d, shards=S,
                                            seed=S)
                k2, _ = on_host(lambda *a: P.distinct_apply_plain(
                    *a, d=d, shards=S, seed=S), x, keep1, ms, mv)
                ok &= check(same(k, k2), f"distinct_apply S={S} {name} "
                            f"w={w}")
                # a mesh position's lanes with their lane base: each part
                # against its plain run, and together the whole apply's
                L = max(1, S // MESH_POSITIONS)
                parts = []
                for lane0 in range(0, S, L):
                    cut = slice(lane0 * n, (lane0 + L) * n)
                    kp = P.distinct_apply_kernel(
                        x[cut], keep1[cut], ms, mv, d=d, shards=L, seed=S,
                        lane0=lane0, w=w)
                    kp2, _ = on_host(lambda *a: P.distinct_apply_plain(
                        *a, d=d, shards=L, seed=S, lane0=lane0, w=w),
                        x[cut], keep1[cut], ms, mv)
                    ok &= check(same(kp, kp2), f"distinct_apply S={S} "
                                f"{name} w={w} lane0={lane0}")
                    parts.append(kp)
                ok &= check(same(torch.cat(parts), k), f"distinct_apply "
                            f"S={S} {name} w={w}: the positions' applies "
                            "differ from the whole one")
        say("kernels", S=S, n=n, distinct_apply=ok,
            s=round(time.perf_counter() - t0, 3))


def rowpar_streams(torch, g, m):
    """The streams the row-parallel walks are held to, on the card: one key
    as 90 % of the stream, a few keys (every key in one row at d = 1), two
    keys alternating, uniform keys, and float32 values (the JAX package's
    conversions to uint32 slots)."""
    hot = torch.randint(0, 300, (m,), generator=g)
    hot[torch.rand(m, generator=g) < 0.9] = 7
    floats = torch.tensor(FLOAT_KEYS)[torch.randint(
        0, len(FLOAT_KEYS), (m,), generator=g)]
    floats[::3] = torch.randint(0, 6, (floats[::3].numel(),),
                                generator=g).float()
    out = {"hot key": hot, "one row": torch.randint(0, 9, (m,), generator=g),
           "alternating": torch.where(torch.arange(m) % 2 == 0, 3, 11),
           "uniform": torch.randint(0, 300, (m,), generator=g)}
    out = {k: v.to(torch.int32).view(torch.uint32).cuda()
           for k, v in out.items()}
    out["float32"] = floats.cuda()
    return out


def phase_kernels_rowpar(torch, g):
    """The row-parallel DISTINCT (FIFO and LRU) and GROUP BY walks against
    their plain versions on adversarial inputs: a hot key, every key in
    one row, two keys alternating in one row, d not a power of two and
    d >= 2^16 (the modulo branch of hash_mod), float32 keys, GROUP BY with
    invalid (padding) entries and with the hot key in slot w - 1, rows of
    more than 32 slots (the shared-memory walk), at S = 1, 8 and 128. The
    plain versions run on the host (on_host)."""
    from repro_torch.kernels import groupby_scan as G
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import ref as R

    for S, n in ROWPAR_LANE.items():
        t0 = time.perf_counter()
        m = S * n
        xs = rowpar_streams(torch, g, m)
        vals = (torch.randn(m, generator=g) * 100).cuda()
        valid = (torch.rand(m, generator=g) < 0.9).cuda()
        ok_d = ok_g = True
        for name, d, w in ROWPAR_DISTINCT:
            x = xs[name]
            for policy in ("fifo", "lru"):
                out = P.distinct_shard_states_kernel(
                    x, d=d, w=w, shards=S, block=1, seed=S, policy=policy)
                plain = (R.distinct_lru_ref if policy == "lru" else
                         lambda v, **kw: R.distinct_block_ref(v, block=1,
                                                              **kw))
                (k2, st2), _ = on_host(lambda u: plain(
                    u, d=d, w=w, seed=S, return_state=True), x.view(S, n))
                ok_d &= check(same(out[0], k2.reshape(-1)) and all(
                    same(a, b) for a, b in zip(out[1:], st2)),
                    f"distinct_pass1 row-parallel S={S} {name} d={d} w={w} "
                    f"{policy}")
        for name, d, w, aggs in ROWPAR_GROUPBY:
            k = xs[name]
            for agg in aggs:
                for v in (None, valid):
                    ev, st = G.groupby_pass1_kernel(k, vals, v, d=d, w=w,
                                                    agg=agg, shards=S, seed=S)
                    (ev2, st2), _ = on_host(
                        lambda a, b, c: G.groupby_pass1_plain(
                            a, b, c, d=d, w=w, agg=agg, seed=S),
                        k.view(S, n), vals.view(S, n),
                        None if v is None else v.view(S, n))
                    ok_g &= check(
                        all(same(a, b.reshape(-1)) for a, b in zip(ev, ev2))
                        and all(same(a, b) for a, b in zip(st, st2)),
                        f"groupby_pass1 row-parallel S={S} {name} d={d} "
                        f"w={w} {agg} valid={v is not None}")
        say("kernels", S=S, m=m, distinct_row_parallel=ok_d,
            groupby_row_parallel=ok_g, s=round(time.perf_counter() - t0, 3))


def prefix_streams(torch, g, S, n):
    """The streams the B = 1 TOP-N walk and the SKYLINE prefix merge are
    held to, S lanes of n entries on the card: TOP-N values by name, and
    SKYLINE (points [S*n, 2], score) by name. Ascending streams insert at
    every entry; +-0 ties keep their first-come bits; a NaN (a SUM
    coordinate of NaN, an APH coordinate of +inf) first, mid-lane and at
    the 256-entry chunk boundary of every lane; values and SUM scores at,
    below and just above NEG."""
    from repro_torch.constants import NEG

    m = S * n
    i = torch.arange(n, dtype=torch.float32).repeat(S)
    r = torch.rand(m, generator=g) * 1000
    zero = torch.tensor([0.0, -0.0, -1.0])
    t = {"random": r, "ascending": i, "descending": -i,
         "all equal": torch.full((m,), 3.0),
         "zeros": zero[torch.randint(0, 3, (m,), generator=g)]}
    for name, at in (("nan first", 0), ("nan mid", n // 2)):
        v = r.clone().view(S, n)
        v[:, at] = float("nan")
        t[name] = v.reshape(m)
    low = r.clone()
    low[::3], low[1::4], low[2::5] = -float("inf"), float(NEG), -3e38
    t["low"] = low
    p = torch.rand(m, 2, generator=g) * 1000
    z = zero[torch.randint(0, 2, (m, 2), generator=g)]
    z[::5] = -1.0
    z[::7, 0] = 1.0
    sky = {"random aph": (p, "aph"), "random sum": (p, "sum"),
           "ascending": (torch.stack([i + 1, i + 1], 1), "aph"),
           "descending": (torch.stack([n - i, n - i], 1), "sum"),
           "all equal": (torch.full((m, 2), 5.0), "aph"),
           "zeros": (z, "sum")}
    for name, at, val, score in (("nan first", 0, float("nan"), "sum"),
                                 ("nan mid", n // 2, float("inf"), "aph"),
                                 ("nan at a chunk", min(n - 1, 256),
                                  float("nan"), "sum")):
        q = p.clone().view(S, n, 2)
        q[:, at, 1] = val
        sky[name] = (q.reshape(m, 2), score)
    q = p.clone()
    q[::3] = torch.tensor([-3e38, -5e37])
    q[1::5, 0] = -float("inf")
    q[2::7] = torch.tensor([-3e38, 0.0])
    sky["low"] = (q, "sum")
    return ({k: v.cuda() for k, v in t.items()},
            {k: (v.contiguous().cuda(), sc) for k, (v, sc) in sky.items()})


def phase_kernels_prefix(torch, g):
    """The B = 1 TOP-N walk and the SKYLINE prefix merge (B = 1, engine
    form, and B = 32, kernel form) against their plain versions on the
    adversarial streams of prefix_streams, at S = 1, 8 and 128: keep and
    final state, bit for bit (same_bits). The plain versions run on the
    host (on_host)."""
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import ref as R

    B = PREFIX_SKYLINE_B
    for S, n in ROWPAR_LANE.items():
        t0 = time.perf_counter()
        vals, sky = prefix_streams(torch, g, S, n)
        ok_t = ok_s = True
        for name, x in vals.items():
            for d, w in PREFIX_TOPN:
                k, st = P.topn_shard_states_kernel(x, d=d, w=w, shards=S,
                                                   block=1, seed=S)
                (k2, st2), _ = on_host(lambda u: R.topn_block_ref(
                    u, d=d, w=w, block=1, seed=S, return_state=True),
                    x.view(S, n))
                ok_t &= check(same_bits(k, k2.reshape(-1))
                              and same_bits(st, st2),
                              f"topn_pass1 walk S={S} {name} d={d} w={w}")
        for name, (x, score) in sky.items():
            for block, form, nb in ((1, "engine", n), (B, "kernel",
                                                       n // B * B)):
                xb = x.view(S, n, 2)[:, :nb].contiguous()
                for w in PREFIX_SKYLINE_W:
                    k, pt, sc = P.skyline_shard_states_kernel(
                        xb.view(-1, 2), w=w, shards=S, block=block,
                        score=score, form=form)
                    (k2, (pt2, sc2)), _ = on_host(
                        lambda u: R.skyline_block_ref(
                            u, w=w, block=block, score=score, form=form,
                            return_state=True), xb)
                    ok_s &= check(
                        same_bits(k, k2.reshape(-1)) and same_bits(pt, pt2)
                        and same_bits(sc, sc2),
                        f"skyline_pass1 prefix merge S={S} {name} B={block} "
                        f"w={w}")
        say("kernels", S=S, n=n, topn_walk=ok_t, skyline_prefix_merge=ok_s,
            s=round(time.perf_counter() - t0, 3))


# the TOP-N apply's layouts on the card: (S, L, view offset in entries, d, w);
# L % 4 in {0, 1, 2, 3}, views 1 and 3 entries into their storage, and
# d = 60000, whose minima do not fit shared memory (read from global memory)
APPLY_SHAPES = ((8, 1024, 0, 512, 8), (8, 1025, 1, 512, 8),
                (8, 1026, 0, 37, 1), (8, 1027, 3, 512, 8),
                (128, 4099, 0, 512, 8), (3, 7, 2, 1, 1),
                (16, 2048, 1, 60000, 8),
                # two columns staged above 48 KB, large, small, large: the
                # third launch reuses the first's cached plan after the
                # second lowered the kernel's shared-memory limit
                (8, 1024, 0, 50000, 8), (8, 1024, 0, 20000, 8),
                (8, 1024, 0, 50000, 8))
# merged columns of the apply's cases: a special row minimum or two
APPLY_COLUMNS = ("finite", "+inf", "-inf", "nan", "zeros and subnormals",
                 "two infs")
SUBNORMAL_M = 1 << 20          # entries of phase subnormals' columns
SUBNORMAL_PREFIX = 1 << 12     # entries of its one-lane B = 1 scans


def apply_column(torch, g, name, d):
    """The [d] row minima of one case (APPLY_COLUMNS), on the host."""
    col = torch.randn(d, generator=g)
    rows = torch.randperm(d, generator=g)[:2]
    if name == "zeros and subnormals":
        pick = torch.randint(0, 4, (d,), generator=g)
        col = torch.tensor([0.0, -0.0, 1e-40, -1e-40])[pick]
    elif name in ("+inf", "-inf", "nan"):
        col[rows[0]] = float(name)
    elif name == "two infs" and d > 1:
        col[rows[0]], col[rows[1]] = float("inf"), -float("inf")
    return col


def phase_kernels_topn_apply(torch, g):
    """topn_apply in both families against its plain version on the card:
    every layout of APPLY_SHAPES (shards off 16 bytes, views, strided
    merged matrices of w = 1 and 8, the global-memory route) under every
    merged column of APPLY_COLUMNS (A24's pattern: +inf, NaN, +-0, and
    subnormals), on values salted with +-0 and +-1e-40."""
    from repro_torch.kernels import parallel as P

    for S, L, off, d, w in APPLY_SHAPES:
        m = S * L
        v = salt_subnormals(torch, g, torch.randn(m + off, generator=g))
        x = v.to("cuda")[off:]
        ok = True
        for name in APPLY_COLUMNS:
            wide = torch.full((d, w + 3), 9.0)
            wide[:, w - 1] = apply_column(torch, g, name, d)
            merged = wide.to("cuda")[:, :w]
            for fam in P.FAMILIES:
                k = P.topn_apply_kernel(x, merged, d=d, shards=S, seed=5,
                                        family=fam)
                k2 = P.topn_apply_plain(x, merged[:, -1], d=d, shards=S,
                                        seed=5, family=fam)
                ok &= check(same(k, k2), f"topn_apply {fam} S={S} L={L} "
                            f"view={off} d={d} w={w} column {name}")
        say("kernels", kernel="topn_apply", S=S, L=L, view=off, d=d, w=w,
            families=json.dumps(P.FAMILIES), ok=ok)


# ROADMAP Queue 3 A27: the kernels' family of TOP-N pass 1 keeps as the
# Pallas kernels' one-hot read of the row minimum does. (S, B, d, w, lane
# entries) of the small cases, each under every salt share of A27_SHARES
A27_CASES = ((1, 256, 512, 8, 1 << 16), (8, 256, 37, 8, 4096),
             (128, 256, 512, 8, 2048), (1, 2, 3, 1, 512), (8, 32, 1, 4, 1024),
             (1, 1, 5, 2, 999), (8, 1, 3, 2, 64))
A27_SHARES = (0.0, 1e-3, 0.05, 0.3)
# 1 entry in A27_SALT[S] of the salted column is +inf, 1 in 4 A27_SALT[S]
# NaN: about 16 +inf entries a row of every lane (d = 512, w = 8), so that
# rows' minima turn +inf
A27_SALT = {1: 1 << 12, SHARDS: 1 << 5}


def a27_salt(torch, x, S, seed=27):
    """x (a copy) with 1 entry in A27_SALT[S] set to +inf and 1 in 4
    A27_SALT[S] to NaN, at positions drawn by numpy from ``seed``: the same
    column on the host and on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    m, salt = x.numel(), A27_SALT[S]
    inf_at = torch.from_numpy(rng.integers(0, m, m // salt))
    nan_at = torch.from_numpy(rng.integers(0, m, m // (4 * salt)))
    x = x.clone()
    x[inf_at.to(x.device)] = float("inf")
    x[nan_at.to(x.device)] = float("nan")
    return x


def topn_pass1_tinf(torch, P, x, S, B):
    """Pass 1 of the kernels' family by its C entry, before the fix-up, in
    the form the wrapper picks: (the direct read's keep, the matrices, tinf,
    the block of each row's last insert)."""
    from repro_torch.kernels.common import ptr, workspace

    m, d, w = x.numel(), TOPN["d"], TOPN["w"]
    n = m // S
    keep = torch.empty(m, dtype=torch.bool, device="cuda")
    st = torch.empty((S, d, w), dtype=torch.float32, device="cuda")
    tinf = P._tinf(S, d, x.device)
    walk = B == 1 or P.use_block_walk(S, x.device)
    work = workspace(x.device, "topn_pass1_workspace", S, n, d) if walk \
        else None
    entry = P.TOPN_BLOCK_WALK if walk and B > 1 else P.TOPN_PASS1
    entry.launch(x.device, ptr(x), ptr(keep), ptr(st), S, n, d, w, B, 0,
                 None if work is None else ptr(work), ptr(tinf),
                 *(() if entry is P.TOPN_BLOCK_WALK else (0, 0)))
    return keep, st, tinf


def phase_kernels_a27(torch, P, R, O, host):
    """Queue 3 A27 on the card: the smallest input; both families of TOP-N
    pass 1 (the kernels' one-hot keep with its fix-up, the engine's direct
    read) in both B > 1 forms and at B = 1, on streams salted with +inf and
    NaN, against the plain versions on a CPU copy; and the salted 2^25-entry
    column (a27_salt) at S = 128, B = 256 against the plain version on the
    card (S = 1 is compared in phase timing, its plain loop in a HostPlain
    worker), with the fix-up alone against ref.onehot_keep at both shapes
    and its time."""
    inf, nan = float("inf"), float("nan")
    k = O.topn_prune(torch.full((4,), inf, device="cuda"), d=2, w=1, block=2)
    check(k.tolist() == [True, True, True, False],
          "A27: ops.topn_prune([inf] * 4, d=2, w=1, block=2) keeps "
          f"{k.tolist()}, the reference [1, 1, 1, 0]")
    g = torch.Generator().manual_seed(27)
    real = P.use_block_walk
    try:
        for form in ("block walk", "block kernel"):
            P.use_block_walk = lambda s, dev, f=form: f == "block walk"
            for S, B, d, w, n in A27_CASES:
                if B == 1 and form != "block walk":
                    continue
                ok = True
                for share in A27_SHARES:
                    v = torch.randn(S * n, generator=g)
                    u = torch.rand(S * n, generator=g)
                    v[u < share] = inf
                    v[(u >= share) & (u < 1.2 * share)] = nan
                    kw = dict(d=d, w=w, shards=S, block=B)
                    kc, sc = P.topn_shard_states_kernel(v.cuda(), **kw)
                    kp, sp = P.topn_shard_states_kernel(v, **kw)
                    ke, se = P.topn_shard_states_kernel(v.cuda(),
                                                        family="engine", **kw)
                    kd, sd = R.topn_block_ref(v.reshape(S, -1), d=d, w=w,
                                              block=B, return_state=True)
                    ok &= check(same(kc.cpu(), kp) and same_bits(sc, sp)
                                and same(ke.cpu(), kd.reshape(-1))
                                and same_bits(se, sd),
                                f"A27 {form} S={S} B={B} d={d} w={w} "
                                f"salt={share}")
                say("kernels", case="A27", form=json.dumps(form), S=S, B=B,
                    d=d, w=w, shares=json.dumps(A27_SHARES), ok=ok)
    finally:
        P.use_block_walk = real
    for S in (SHARDS, 1):
        xs = a27_salt(torch, host.cols["topn_pass1"].cuda(), S)
        keep, st = P.topn_shard_states_kernel(xs, shards=S, block=256,
                                              **TOPN)
        plain_s = None
        if S > 1:
            (k2, st2), plain_s = sync_time(lambda: R.topn_block_ref(
                xs.reshape(S, -1), block=256, return_state=True, onehot=True,
                **TOPN))
            check(same(keep, k2.reshape(-1)) and same_bits(st, st2),
                  f"A27 salted 2^25 S={S} B=256 differs from the plain "
                  "version")
        direct, st3, tinf = topn_pass1_tinf(torch, P, xs, S, 256)
        want = R.onehot_keep(direct.view(S, -1), st3, tinf.view(S, -1).to(
            torch.int64), d=TOPN["d"], block=256).reshape(-1)
        fixed = direct.clone()
        P.topn_onehot_fixup(fixed, st3, tinf, shards=S, d=TOPN["d"],
                            block=256)
        check(same(fixed, want) and same(fixed, keep),
              f"A27 salted 2^25 S={S}: topn_onehot_fixup differs from "
              "ref.onehot_keep")
        fix_ms = event_ms(lambda: P.topn_onehot_fixup(
            fixed, st3, tinf, shards=S, d=TOPN["d"], block=256), 10)
        say("kernels", case="A27 salted column", S=S, B=256, entries=M_MAIN,
            inf_rows=int((st[..., -1] == inf).sum()),
            kept=int(keep.sum()), kept_direct=int(direct.sum()),
            plain_on=json.dumps("card" if S > 1 else "host, phase timing"),
            plain_s=json.dumps(plain_s),
            fixup_ms=fix_ms, pass1_ms=event_ms(
                lambda: P.topn_shard_states_kernel(xs, shards=S, block=256,
                                                   **TOPN), 5))


def a27_host_check(torch, P, host):
    """The salted 2^25-entry column at S = 1, B = 256 (the block walk and its
    fix-up) against the plain version's run in a HostPlain worker."""
    xs = a27_salt(torch, host.cols["topn_pass1"].cuda(), 1)
    keep, st = P.topn_shard_states_kernel(xs, shards=1, block=256, **TOPN)
    (k2, st2), plain_s = host.get(("topn_pass1_a27", 1, 256))
    ok = check(same(keep, k2.reshape(-1)) and same_bits(st, st2),
               "A27 salted 2^25 S=1 B=256 differs from the plain version")
    say("timing", case="A27 salted column", S=1, B=256, ok=ok,
        kept=int(keep.sum()), plain_s=round(plain_s, 3))


def salt_subnormals(torch, g, x):
    """x (f32, on g's device) with 1 entry in 16 replaced by +-k * 1e-40, k
    from 1 to 100 drawn from g, of both signs, and 1 in 32 by +-0."""
    kw = dict(generator=g, device=x.device)
    u = torch.rand(x.shape, **kw)
    k = torch.randint(1, 101, x.shape, **kw).float()
    sign = torch.where(torch.rand(x.shape, **kw) < 0.5, -1.0, 1.0)
    x = torch.where(u < 1 / 16, sign * k * 1e-40, x)
    return torch.where((u >= 1 / 16) & (u < 3 / 32), sign * 0.0, x)


def phase_subnormals(torch, P, R, table):
    """Every kernel that computes on f32 values, on the card, on columns
    salted with subnormals (salt_subnormals: XLA flushes them in every add,
    minimum, maximum and compare and keeps them in a copy, ROADMAP Queue 3
    A25), held bit for bit, masks and states, every NaN as one, against its
    plain version on a CPU copy: at the main path's shapes on the first
    SUBNORMAL_M entries of its columns (the one-lane B = 1 scans on their
    first SUBNORMAL_PREFIX; the applies, the ladder and the Count-Min
    build against the plain version on the card), and the TOP-N apply
    also on the whole 2^25-entry column."""
    from repro_torch.kernels import cms_sketch as C
    from repro_torch.kernels import groupby_scan as G
    from repro_torch.kernels import rle_scan as RL
    from repro_torch.kernels import topn_det_scan as TD

    g = torch.Generator().manual_seed(2025)
    n = SUBNORMAL_M
    xs = salt_subnormals(torch, g, table.cols["ad_revenue"][:n].cpu())
    dur = salt_subnormals(torch, g, table.cols["duration"][:n].cpu().float())
    keys = table.cols["source_ip"][:n]
    # DISTINCT on f32 keys: small integers (hits) among the subnormals
    fk = salt_subnormals(torch, g, (keys.view(torch.int32) % 4096).float()
                         .cpu())
    pts = torch.stack([xs, dur], 1)

    def held(name, kernel, plain, *args, card=False):
        """kernel against plain, the plain version on a CPU copy (on the
        card when ``card``: its loop is over blocks of entries, not over
        entries)."""
        t0 = time.perf_counter()
        got = kernel(*(to_card(a) for a in args))
        got = got if isinstance(got, tuple) else (got,)
        want, plain_s = (sync_time(lambda: plain(*to_card(args))) if card
                         else on_host(plain, *args))
        want = want if isinstance(want, tuple) else (want,)
        ok = check(len(got) == len(want) and all(
            same_bits(a, b) for a, b in zip(got, want)),
            f"subnormals: {name} differs from its plain version")
        say("subnormals", kernel=json.dumps(name), ok=ok,
            entries=args[0].shape[0], plain_s=round(plain_s, 3),
            s=round(time.perf_counter() - t0, 3))
        return got

    cases = [(1, 1, SUBNORMAL_PREFIX), (SHARDS, 1, n), (1, 256, n),
             (SHARDS, 256, n)]
    merged = {}
    for S, B, m in cases:
        st = held(f"topn_pass1 S={S} B={B}",
                  lambda v: P.topn_shard_states_kernel(
                      v, shards=S, block=B, **TOPN),
                  lambda v: tuple(t.reshape(-1) if i == 0 else t
                                  for i, t in enumerate(R.topn_block_ref(
                                      v.reshape(S, -1), block=B,
                                      return_state=True, **TOPN))),
                  xs[:m])
        if S > 1:
            merged[B] = P.merge_topn_states(st[1], TOPN["w"])
        for policy in (("fifo", "lru") if B == 1 else ("fifo",)):
            out = held(f"distinct_pass1 {policy} S={S} B={B} float32",
                       lambda v: P.distinct_shard_states_kernel(
                           v, shards=S, block=B, policy=policy, **DISTINCT),
                       lambda v: distinct_plain(R, v, S, B, policy),
                       fk[:m])
            if S > 1:
                ms, mv = P.merge_distinct_states(out[1], out[2])
                held(f"distinct_apply after {policy} S={S} B={B} float32",
                     lambda v, k1: P.distinct_apply_kernel(
                         v, k1, ms, mv, d=DISTINCT["d"], shards=S),
                     lambda v, k1: P.distinct_apply_plain(
                         v, k1, ms, mv, d=DISTINCT["d"], shards=S),
                     fk[:m], out[0], card=True)
        for score in ("aph", "sum"):
            form = "kernel" if B > 1 else "engine"
            out = held(f"skyline_pass1 {score} S={S} B={B}",
                       lambda p: P.skyline_shard_states_kernel(
                           p, w=SKYLINE["w"], shards=S, block=B, score=score,
                           form=form),
                       lambda p: skyline_plain(R, p, S, B, score, form),
                       pts[:m])
            if S > 1:
                mp, msc = P.merge_skyline_states(out[1], out[2])
                held(f"skyline_apply {score} S={S} B={B}",
                     lambda p: P.skyline_apply_kernel(p, mp, msc),
                     lambda p: P.skyline_apply_plain(p, mp, msc), pts[:m],
                     card=True)
    for B, mg in merged.items():
        for fam in P.FAMILIES:
            held(f"topn_apply {fam} after B={B}",
                 lambda v: P.topn_apply_kernel(v, mg, d=TOPN["d"],
                                               shards=SHARDS, family=fam),
                 lambda v: P.topn_apply_plain(v, mg[:, -1], d=TOPN["d"],
                                              shards=SHARDS, family=fam),
                 xs, card=True)
    # COUNT folds + 1.0 and reads no value
    for S, m in ((1, SUBNORMAL_PREFIX), (SHARDS, n)):
        for agg in ("sum", "min", "max"):
            held(f"groupby_pass1 {agg} S={S}",
                 lambda k, v: flat(G.groupby_pass1_kernel(
                     k, v, d=GROUPBY["d"], w=GROUPBY["w"], agg=agg,
                     shards=S)),
                 lambda k, v: flat(G.groupby_pass1_kernel(
                     k, v, d=GROUPBY["d"], w=GROUPBY["w"], agg=agg,
                     shards=S)), keys[:m].cpu(), xs[:m])
    xc = xs.to("cuda")
    for S in (1, SHARDS):
        a = TD.topn_det_pass1_kernel(xc, shards=S, **TOPN_DET)
        b = TD.topn_det_pass1_plain(xc.reshape(S, -1), **TOPN_DET)
        ok = check(same(a[0], b[0].reshape(-1)) and all(
            same_bits(u, v) for u, v in zip(a[1], b[1])),
            f"subnormals: topn_det_pass1 S={S} differs from its plain version")
        say("subnormals", kernel="topn_det_pass1", S=S, entries=n, ok=ok)
    runs = 1 << 16
    rv = salt_subnormals(torch, g, torch.rand(runs, generator=g) * 100)
    rl = torch.randint(0, 65, (runs,), generator=g, dtype=torch.int32)
    held("rle_topn_det", lambda v, ln: RL.rle_topn_det_kernel(
        v, ln, **RLE_TOPN), lambda v, ln: RL.rle_topn_det_ref(
        v, ln, **RLE_TOPN), rv, rl)
    # integer weights below 16 among the subnormals: every sum is exact in
    # any order, so the plain build on the card (atomics) is its reference
    wts = salt_subnormals(torch, g, (table.cols["duration"][:n].cpu() % 16)
                          .float()).to("cuda")
    for fam, S in (("kernel", 1), ("engine", SHARDS)):
        a = C.cms_build_kernel(keys, wts, family=fam, shards=S, **CMS_OPS)
        b = C.cms_build_plain(keys, wts, family=fam, shards=S, **CMS_OPS)
        ok = check(same_bits(a, b), f"subnormals: cms_build {fam} S={S} "
                   "differs from its plain version")
        say("subnormals", kernel="cms_build", family=fam, S=S, entries=n,
            ok=ok)
    # the apply on the whole column, salted on the card
    gc = torch.Generator(device="cuda").manual_seed(2025)
    xc = salt_subnormals(torch, gc, table.cols["ad_revenue"])
    ok = True
    for B in merged:
        for fam in P.FAMILIES:
            mg = merged[B]
            a = P.topn_apply_kernel(xc, mg, d=TOPN["d"], shards=SHARDS,
                                    family=fam)
            b = P.topn_apply_plain(xc, mg[:, -1], d=TOPN["d"], shards=SHARDS,
                                   family=fam)
            ok &= check(same(a, b), f"subnormals: topn_apply {fam} after "
                        f"B={B} differs from its plain version on the "
                        "2^25-entry column")
    say("subnormals", kernel="topn_apply", entries=M_MAIN, ok=ok)
    subnormals_a28(torch, table)
    subnormals_a30(torch)


# ROADMAP Queue 3 A28: (family, rows, width, lanes) of the mixed-sign f32
# Count-Min builds, on A28_M keys; 70000 columns do not fit the walk's row
# in shared memory, nor the partial build's table
A28_SHAPES = (("engine", 3, 1024, 1), ("engine", 3, 4096, 8),
              ("kernel", 3, 4096, 1), ("engine", 2, 70000, 2))
A28_M = 1 << 20


def subnormals_a28(torch, table):
    """Queue 3 A28 on the card: an f32 Count-Min table whose weights take
    both signs adds in entry order, a flush after each add (the partial
    build flags the signs, and the f32 walk rebuilds the table): the
    smallest input reads FLT_MIN, and weights of both signs in units of
    FLT_MIN / 8 (only the flushes decide the counters) equal the plain
    build on a CPU copy bit for bit at every shape of A28_SHAPES; weights of
    one sign keep the partial build. Prints each route's time, and the
    walk's on the main path's Count-Min shape."""
    from repro_torch import core
    from repro_torch.kernels import cms_sketch as C

    fm = C.FLT_MIN
    t = core.cms_build(torch.tensor([7, 7, 7], dtype=torch.uint32,
                                    device="cuda"),
                       torch.tensor([1.5, -1.0, 1.0], device="cuda") * fm,
                       1, 4).table
    check(t[0, 0].item() == torch.tensor(fm).item(),
          f"A28: the smallest input's cell reads {t[0, 0].item()}, the "
          "reference FLT_MIN")
    g = torch.Generator().manual_seed(28)
    keys = torch.randint(0, 5000, (A28_M,), generator=g).to(torch.uint32)
    units = torch.tensor([-2, -1.5, -1, -0.5, 0.5, 1, 1.5, 2])
    w = units[torch.randint(0, 8, (A28_M,), generator=g)] * fm
    w[torch.rand(A28_M, generator=g) < 0.1] *= 3.25
    kc, wc = keys.cuda(), w.cuda()
    for fam, rows, width, lanes in A28_SHAPES:
        kw = dict(rows=rows, width=width, family=fam, shards=lanes)
        ok = True
        for name, wts in (("both signs", w), ("one sign", w.abs())):
            got = C.cms_build_kernel(kc, wts.cuda(), **kw)
            want, plain_s = on_host(lambda: C.cms_build_plain(keys, wts,
                                                              **kw))
            ok &= check(same_bits(got, want), f"A28 {name} {fam} "
                        f"{rows}x{width} lanes={lanes} differs from the "
                        "plain build")
            say("subnormals", case="A28", weights=json.dumps(name),
                family=fam, rows=rows, width=width, lanes=lanes, keys=A28_M,
                ms=event_ms(lambda: C.cms_build_kernel(kc, wts.cuda(), **kw),
                            3), plain_s=round(plain_s, 3), ok=ok)
    src = table.cols["source_ip"]
    mixed = table.cols["duration"].float()
    mixed[::7] *= -1
    _, secs = sync_time(lambda: C.cms_build_kernel(src, mixed, **CMS_OPS))
    say("subnormals", case="A28 walk at the main Count-Min shape",
        keys=M_MAIN, ms=event_ms(lambda: C.cms_build_kernel(
            src, mixed, **CMS_OPS), 2), first_s=round(secs, 3))


# ROADMAP Queue 3 A30: the Pallas build's short blocks (32 keys or fewer)
# and the widths whose first vectorised block differs (7: 15 / 14, 16: 22
# / 20), 3 rows, on A30_M keys
A30_BLOCKS = (9, 15, 16, 17, 20, 22, 24, 31, 32)
A30_WIDTHS = (7, 16)
A30_M = 2040


def subnormals_a30(torch):
    """Queue 3 A30 on the card: ``cms_build_blocks`` sums a block of 32
    keys or fewer in the order of XLA's fused loop (in key order, or by
    lanes, a halving tree and the rest in order, by block, width and row),
    held bit for bit to the plain build on a CPU copy, on weights of both
    signs in units of FLT_MIN / 8 (the flushes decide the counters), the
    stream padded to whole blocks with (key 0, weight 0.0) as the ops entry
    point pads it."""
    from repro_torch.kernels import cms_sketch as C

    g = torch.Generator().manual_seed(30)
    ok = True
    for block in A30_BLOCKS:
        for width in A30_WIDTHS:
            mp = -(-A30_M // block) * block
            keys = torch.zeros(mp, dtype=torch.int32).view(torch.uint32)
            keys[:A30_M] = torch.randint(0, 5000, (A30_M,),
                                         generator=g).to(torch.uint32)
            w = torch.zeros(mp)
            w[:A30_M] = (torch.randint(8, 40, (A30_M,), generator=g)
                         * (torch.randint(0, 2, (A30_M,), generator=g) * 2
                            - 1)).float() * (C.FLT_MIN / 8)
            kw = dict(rows=3, width=width, block=block)
            got = C.cms_build_kernel(keys.cuda(), w.cuda(), **kw)
            want, _ = on_host(lambda: C.cms_build_plain(keys, w, **kw))
            ok &= check(same_bits(got, want), f"A30 cms_build_blocks "
                        f"block={block} width={width} differs from the "
                        "plain build")
    say("subnormals", case="A30", blocks=json.dumps(A30_BLOCKS),
        widths=json.dumps(A30_WIDTHS), keys=A30_M, ok=ok)


# the engine calls of PERF.md section 5: (name, algo, streams of the
# uservisits table, params), at SHARDS lanes in phase main
ENGINE_CALLS = (
    ("topn_rand", "topn_rand", ("ad_revenue",), TOPN),
    ("topn_det", "topn_det", ("ad_revenue",), TOPN_DET),
    ("distinct fifo", "distinct", ("source_ip",),
     dict(policy="fifo", **DISTINCT)),
    ("distinct lru", "distinct", ("source_ip",), DISTINCT),
    ("skyline", "skyline", SKY_COLS, SKYLINE),
    ("having count", "having", HAVING_COUNT[:2], HAVING_COUNT[2]),
    ("groupby count", "groupby", ("source_ip", "ad_revenue"),
     dict(agg="count", **GROUPBY)),
)


def engine_streams(torch, table, algo, cols):
    if algo == "skyline":
        return (torch.stack([table.cols[c].float() for c in cols], -1),)
    return tuple(table.cols[c] for c in cols)


def phase_planner(torch, table):
    """The analytic planner on the card: each section-5 engine call's merge
    cost c and one lane's state bytes measured by calibrate_merge_cost on
    the card (planner.MEASURED_MERGE_COSTS), the lane count shards="auto"
    resolves at 2^25 entries, engine_prune(mode="two_pass", shards="auto")
    bit-identical to the same call at that S, and its time beside the
    S = 128 call's (each the faster of two calls); then options= against
    the keyword arguments. Returns {algo: one lane's state bytes}."""
    from repro_torch import ExecOptions, core
    from repro_torch.query import QuerySpec, run_query

    sbytes = {}
    for name, algo, cols, params in ENGINE_CALLS:
        streams = engine_streams(torch, table, algo, cols)
        (c, sb), cal_s = sync_time(lambda: core.calibrate_merge_cost(
            algo, streams, params))
        sbytes[algo] = sb
        want = min(core.optimal_shards(M_MAIN, sb, merge_byte_cost=c),
                   M_MAIN)
        auto = core.engine_prune(algo, *streams, mode="two_pass",
                                 shards="auto", **params)
        S = auto.report.meta["shards"]
        fixed = core.engine_prune(algo, *streams, mode="two_pass", shards=S,
                                  **params)
        check(S == want and same(auto.keep, fixed.keep),
              f"planner: {name} shards='auto' (S={S}, the model's {want}) "
              "differs from the same call at that S")
        times = {}
        for lanes in ("auto", SHARDS):
            times[lanes] = min(sync_time(lambda: core.engine_prune(
                algo, *streams, mode="two_pass", shards=lanes,
                **params))[1] for _ in range(2))
        say("planner", call=json.dumps(name), c=c, state_bytes=sb,
            auto_shards=S, calibrate_s=round(cal_s, 4),
            two_pass_auto_s=round(times["auto"], 4),
            two_pass_128_s=round(times[SHARDS], 4),
            kept_auto=int(auto.keep.sum()))
    say("planner", measured_merge_costs=json.dumps(
        core.MEASURED_MERGE_COSTS))
    for name, algo, cols, params in ENGINE_CALLS[:4]:
        streams = engine_streams(torch, table, algo, cols)
        a = core.engine_prune(algo, *streams, options=ExecOptions(
            mode="two_pass", shards=SHARDS, obs="off"), **params)
        b = core.engine_prune(algo, *streams, mode="two_pass", shards=SHARDS,
                              obs="off", **params)
        check(same(a.keep, b.keep) and a.report is None,
              f"planner: {name} options= differs from the keywords")
    spec = QuerySpec("distinct", ("source_ip",), DISTINCT)
    enc = table.encode("source_ip")
    a = run_query(spec, enc, options=ExecOptions(decode="eager"))
    b = run_query(spec, enc, decode="eager")
    check(same(a["keep"], b["keep"]), "planner: run_query options= differs "
          "from the keywords")
    say("planner", options_checked=5)
    return sbytes


OBS_SPANS = {"engine_prune.scan", "engine_prune.pass1",
             "engine_prune.gather_merge", "engine_prune.pass2_apply"}


def phase_obs(torch, paths, sbytes):
    """Every run_query and engine_prune path of phase main at the three obs
    levels (the process default, set for each call): keep masks identical;
    no report at "off" nor for JOIN and FILTER; at "counters" and "trace"
    the report's entries_scanned is the stream's length, entries_kept the
    engine mask's survivors (GROUP BY's engine mask keeps none),
    decode_skipped_ratio 1 - kept / scanned for encoded streams, and a
    two_pass call's state_bytes_shipped S times one lane's state bytes
    (phase planner), with one merge collective; the trace written to a
    temporary file and parsed. Prints each call's wall time at "off" and at
    "counters" (and once more for calls under a second)."""
    import tempfile

    from repro_torch import obs

    names = [n for n in paths if n.startswith(("run_query", "engine"))]
    obs.TRACER.reset()
    spans = 0
    try:
        for name in names:
            run, _, keep_of, _ = paths[name]
            res, secs = {}, {}
            for lvl in obs.OBS_MODES:
                obs.set_default_level(lvl)
                res[lvl], secs[lvl] = sync_time(run)
            again = {}
            if secs["off"] < 1.0:
                for lvl in ("off", "counters"):
                    obs.set_default_level(lvl)
                    again[lvl] = round(sync_time(run)[1], 4)
            obs.set_default_level("counters")
            keeps = {lvl: keep_of(r) for lvl, r in res.items()}
            ok = check(all(same(keeps["off"], k) for k in keeps.values()),
                       f"obs: {name}: the keep mask differs between levels")
            reps = {lvl: r["report"] if isinstance(r, dict) else r.report
                    for lvl, r in res.items()}
            if name.startswith(("run_query_join", "run_query_filter")) \
                    or reps["off"] is not None:
                # JOIN and FILTER have their own bodies and no report
                ok &= check(name.startswith(("run_query_join",
                                             "run_query_filter"))
                            and all(r is None for r in reps.values()),
                            f"obs: {name}: a report where there is none")
            else:
                for lvl in ("counters", "trace"):
                    rep = reps[lvl]
                    m = rep.meta["m"]
                    keep = keeps[lvl]
                    kept = (0 if name.startswith("run_query_groupby")
                            else int(keep.sum()))
                    ok &= check(rep.entries_scanned == m
                                and (keep.numel() != m
                                     or rep.entries_kept == kept),
                                f"obs: {name} {lvl}: counters differ from "
                                "the mask")
                    if rep.meta["encoded"]:
                        ok &= check(rep.counters["decode_skipped_ratio"]
                                    == 1.0 - rep.entries_kept / m,
                                    f"obs: {name}: decode_skipped_ratio")
                    if rep.meta["mode"] == "two_pass":
                        ok &= check(rep.merge_collective_count == 1
                                    and rep.state_bytes_shipped
                                    == rep.meta["shards"]
                                    * sbytes[rep.meta["algo"]],
                                    f"obs: {name}: state_bytes_shipped")
                names_ = {e["name"] for e in reps["trace"].spans}
                spans += len(reps["trace"].spans)
                ok &= check(names_ and names_ <= OBS_SPANS
                            and not reps["counters"].spans,
                            f"obs: {name}: spans {sorted(names_)}")
            say("obs", path=name, ok=ok, s_off=round(secs["off"], 4),
                s_counters=round(secs["counters"], 4),
                s_trace=round(secs["trace"], 4),
                again=json.dumps(again) if again else "null")
    finally:
        obs.set_default_level("counters")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        obs.TRACER.write(path)
        doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    check(len(evs) == spans and all(e["ph"] == "X" and e["dur"] >= 0
                                    for e in evs),
          "obs: the written trace differs from the reports' spans")
    say("obs", trace_events=len(evs), trace_bytes=len(json.dumps(doc)))


def flat(out):
    """A GROUP BY pass 1's (emissions, state) as one tuple."""
    return tuple(out[0]) + tuple(out[1])


def distinct_plain(R, v, S, B, policy):
    ref = R.distinct_lru_ref if policy == "lru" else (
        lambda u, **kw: R.distinct_block_ref(u, block=B, **kw))
    keep, st = ref(v.reshape(S, -1), return_state=True, **DISTINCT)
    return (keep.reshape(-1),) + tuple(st)


def skyline_plain(R, p, S, B, score, form):
    keep, (pts, scs) = R.skyline_block_ref(
        p.reshape(S, -1, p.shape[1]), w=SKYLINE["w"], block=B, score=score,
        form=form, return_state=True)
    return keep.reshape(-1), pts, scs


def phase_dtypes(torch, P):
    """run_query TOP-N (randomized) on an int32 column and DISTINCT on an
    int32 and a float32 column, on the card, against the same queries on a
    CPU copy of the table (the plain versions): the engine hands each kernel
    the dtype it takes."""
    from repro_torch.query import QuerySpec, make_uservisits, run_query

    tabs = {dev: make_uservisits(DTYPE_ROWS, seed=3, device=dev)
            for dev in ("cuda", "cpu")}
    for name, spec, kernel in (
            ("topn_rand int32", QuerySpec("topn", ("duration",),
                                          dict(N=TOPN_N, **TOPN)),
             "topn_pass1"),
            ("distinct int32", QuerySpec("distinct", ("duration",), DISTINCT),
             "distinct_pass1_lru"),
            ("distinct float32", QuerySpec("distinct", ("ad_revenue",),
                                           DISTINCT), "distinct_pass1_lru")):
        P.reset_launch_counts()
        a = run_query(spec, tabs["cuda"])
        launches = {k.name: k.launches for k in P.KERNELS}[kernel]
        b = run_query(spec, tabs["cpu"])
        out_a = a["output"] if isinstance(a["output"], tuple) else (
            a["output"],)
        out_b = b["output"] if isinstance(b["output"], tuple) else (
            b["output"],)
        ok = check(same(a["keep"].cpu(), b["keep"]) and all(
            same(x.cpu(), y) for x, y in zip(out_a, out_b)),
            f"run_query {name} on the card differs from the CPU")
        check(launches > 0, f"run_query {name}: kernel {kernel} was never "
              "launched")
        say("dtypes", query=json.dumps(name), same_as_cpu=ok,
            launches=launches, pruned=round(
                1 - float(a["keep"].float().mean()), 6))
    dtypes_int32_sketches(torch, P)
    dtypes_f16_table(torch, P)


def dtypes_f16_table(torch, P):
    """Float16 Count-Min tables on the card against the plain build (f16
    adds in entry order, as the reference's scatter-add; run on a CPU copy),
    bit for bit with every NaN as one, in both hash families: the engine's
    through core.sketches.cms_build (HAVING SUM on an f16 column) and
    cms_build_kernel, the kernels' through cms_build_kernel. Inputs: 3000
    unit weights on one key (every counter of the key reads 2048, where an
    f32 sum rounded once reads 3000: ROADMAP Queue 3 A20), random f16
    weights of both signs on F16_KEYS keys whose counters pass 2^11, and
    the same in 128 lanes. Each build's time beside its bound: the larger of
    its bytes and its chain, the hottest counter's entries at FADD_CYCLES
    each (f16 adds do not associate, so a counter's adds are one chain)."""
    from repro_torch import core
    from repro_torch.kernels import cms_sketch as C

    g = torch.Generator().manual_seed(22)
    keys = torch.randint(0, F16_KEYS, (1 << 20,), generator=g).to(
        torch.int32).view(torch.uint32)
    wts = (torch.rand(keys.numel(), generator=g) * 24 - 6).half()
    hot = torch.full((3000,), 7, dtype=torch.uint32)
    clock_hz = max_clock_hz()
    rows, width = 3, 4096
    for name, k, w, lanes in (
            ("3000 unit weights on one key", hot,
             torch.ones(3000, dtype=torch.float16), 1),
            ("sums past 2^11, weights of both signs", keys, wts, 1),
            ("sums past 2^11, 128 lanes", keys, wts, 128)):
        kc, wc = k.cuda(), w.cuda()
        for fam in ("engine", "kernel"):
            kw = dict(rows=rows, width=width, family=fam, shards=lanes)
            P.reset_launch_counts()
            if fam == "engine" and lanes == 1:
                got = core.sketches.cms_build(kc, wc, rows, width).table[None]
            else:
                got = C.cms_build_kernel(kc, wc, **kw)
            launches = P.CMS_BUILD.launches
            plain = C.cms_build_plain(k, w, **kw)
            what = f"f16 Count-Min table, {name}, {fam} family"
            ok = check(same_bits(got.cpu(), plain), f"{what}: the card "
                       "differs from the plain build")
            if lanes == 1 and k is hot:
                ok &= check(float(got.float().max()) == 2048.0,
                            f"{what}: the hot key's counters do not read "
                            "2048")
            check(launches > 0, f"{what}: cms_build was never launched")
            ms = event_ms(lambda: C.cms_build_kernel(kc, wc, **kw), 3)
            col = C.row_hashes(k, rows, width, 0, fam)
            lane = torch.arange(k.numel()) // (k.numel() // lanes)
            cell = (lane[:, None] * rows + torch.arange(rows)) * width + col
            hottest = int(torch.bincount(cell[col >= 0]).max())
            io_ms = bytes_ms(k.numel() * 6 + lanes * rows * width * 2)
            chain_ms = hottest * FADD_CYCLES / clock_hz * 1e3
            say("dtypes", query=json.dumps(what), same_as_plain=ok,
                card_max=float(got.float().max()),
                plain_max=float(plain.float().max()), launches=launches,
                ms=ms, hottest_counter=hottest, bound_ms=max(io_ms, chain_ms),
                bound_by="bytes" if io_ms >= chain_ms else "chain")


def dtypes_int32_sketches(torch, P):
    """int32 keys of both signs through ops.bloom_* and ops.cms_* on the
    card, against the plain versions on the same keys (ROADMAP Queue 3
    A11: the Pallas kernels hash an int32 key in signed arithmetic). The
    widths at and above 2^15 hold keys whose probe is -1 and is dropped."""
    from repro_torch.kernels import bloom_filter as B
    from repro_torch.kernels import cms_sketch as C
    from repro_torch.kernels import ops as O

    g = torch.Generator().manual_seed(21)
    keys = torch.randint(-(1 << 31), 1 << 31, (1 << 20,), generator=g,
                         dtype=torch.int64).to(torch.int32)
    # keys whose signed multiply-shift is -1 at width 40000, seed 0
    bad = torch.tensor([-2040099539, -2010473350, -2006560011],
                       dtype=torch.int32)
    keys = torch.cat([bad, keys]).to("cuda")
    wts = torch.randint(0, 5, (keys.numel(),), generator=g).float().cuda()
    for width in (64, 4096, 40000):
        P.reset_launch_counts()
        bits = O.bloom_build(keys, nbits=width)
        q = O.bloom_query(bits, keys[::3].contiguous())
        tb = O.cms_build(keys, wts, rows=3, width=width)
        est = O.cms_query(tb, keys)
        launches = {k.name: k.launches for k in P.KERNELS}
        pb = B.unpack_bits(B.bloom_build_plain(keys, nbits=width),
                           width).float()
        ok = check(same(bits, pb) and same(q, B.bloom_query_plain(
            B.pack_bits(pb > 0.5), keys[::3], nbits=width)),
            f"ops.bloom_* int32 keys width={width} differ from the plain "
            "versions")
        pt = C.cms_build_plain(keys, wts, rows=3, width=width)[0]
        ok &= check(same(tb, pt) and same(est, C.cms_query_plain(pt, keys)),
                    f"ops.cms_* int32 keys width={width} differ from the "
                    "plain versions")
        check(all(launches[k] > 0 for k in ("bloom_build_global",
                                            "bloom_query", "cms_build",
                                            "cms_query")),
              f"int32 sketches width={width}: a kernel was never launched")
        say("dtypes", query=json.dumps(f"int32 keys, bloom and cms, width "
                                       f"{width}"), same_as_plain=ok,
            launches=json.dumps({k: launches[k] for k in (
                "bloom_build_global", "bloom_query", "cms_build",
                "cms_query")}),
            bits_set=int(bits.sum()), upper_half_empty=bool(
                width < (1 << 15) and not bits[width // 2:].any()))
    # a width of 2^24: the modulo branch, the query only (the Pallas build
    # takes widths below 2^16)
    table = torch.randint(0, 9, (3, 1 << 24), generator=g).float().cuda()
    P.reset_launch_counts()
    est = O.cms_query(table, keys)
    fbits = (torch.rand(1 << 24, generator=g) < 0.5).float().cuda()
    q = O.bloom_query(fbits, keys)
    ok = check(same(est, C.cms_query_plain(table, keys)) and same(
        q, B.bloom_query_plain(B.pack_bits(fbits > 0.5), keys,
                               nbits=1 << 24)),
        "ops.cms_query / ops.bloom_query int32 keys at width 2^24 differ "
        "from the plain versions")
    say("dtypes", query=json.dumps("int32 keys, queries, width 2^24"),
        same_as_plain=ok, cms_query=P.CMS_QUERY.launches,
        bloom_query=P.BLOOM_QUERY.launches)


# ------------------------------------------------------------------ phase 3
def rle_layouts(torch):
    """bench_encoded.py's run layout at M_MAIN rows, R = M_MAIN / 64 runs,
    kept apart (equal neighbours are two runs; both scans are exact on
    any cut into runs): (f32 run values of the TOP-N stream, uint32 run
    values of the DISTINCT stream, int32 run lengths), on the card."""
    import numpy as np

    R_ = M_MAIN // RLE_RUN_LEN
    rv_t = np.sort(np.random.default_rng(0).integers(1, 4096, R_)
                   .astype(np.float32))
    rv_d = np.random.default_rng(1).integers(0, 2048, R_).astype(np.uint32)
    rl = torch.full((R_,), RLE_RUN_LEN, dtype=torch.int32, device="cuda")
    return (torch.from_numpy(rv_t).cuda(), torch.from_numpy(rv_d).cuda(), rl)


def skyline_sweep(torch, pts):
    """Exact 2-D skyline (maximising both columns) by sort and sweep, in
    float64, independent of the port: a point survives iff its second
    coordinate is the largest among points with its first coordinate and
    larger than every second coordinate at a strictly larger first one."""
    a, d = pts[:, 0].double(), pts[:, 1].double()
    ua, inv = torch.unique(a, return_inverse=True)
    gmax = torch.full_like(ua, -float("inf")).scatter_reduce(0, inv, d,
                                                             "amax")
    above = gmax.flip(0).cummax(0).values.flip(0)  # max over a' >= a
    above = torch.cat([above[1:], above.new_full((1,), -float("inf"))])
    return (d == gmax[inv]) & (gmax[inv] > above[inv])


def having_truth(torch, keys, values, threshold, agg):
    """(qualifying keys, rows that carry one) by torch.bincount."""
    k = keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    w = None if agg == "count" else values.double()
    sums = torch.bincount(k, weights=w)
    return torch.nonzero(sums > threshold).flatten(), (sums > threshold)[k]


def u64(torch, x):
    """A 32-bit column by value in int64 (torch compares no uint32)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def join_truth(torch, table, rankings):
    """The join of the full columns by an independent sort-merge: page_url
    is a key of rankings (checked), so each uservisits row meets at most
    one ranking; the triples in (key, val_a, val_b) order."""
    dest = u64(torch, table.cols["dest_url"])
    page = u64(torch, rankings.cols["page_url"])
    check(torch.unique(page).numel() == page.numel(),
          "rankings.page_url is not a key")
    sp, order = torch.sort(page)
    pos = torch.searchsorted(sp, dest).clamp(max=sp.numel() - 1)
    hit = sp[pos] == dest
    key = dest[hit]
    va = table.cols["ad_revenue"][hit]
    vb = rankings.cols["page_rank"][order[pos[hit]]]
    o = torch.sort(va, stable=True).indices
    key, va, vb = key[o], va[o], vb[o]
    o = torch.sort(key, stable=True).indices
    return (key[o], va[o], vb[o]), hit, torch.isin(page, dest)


def groupby_truth(torch, table):
    """(keys, f64 SUM(ad_revenue), COUNT(*)) by source_ip, by bincount."""
    k = u64(torch, table.cols["source_ip"])
    sums = torch.bincount(k, weights=table.cols["ad_revenue"].double())
    counts = torch.bincount(k)
    keys = torch.nonzero(counts).flatten()
    return keys, sums[keys], counts[keys]


def filter_formulas(core, page_rank_cut):
    """(name, table, columns, formula, truth(cols)) of the FILTER queries:
    the benchmark's Query 1 on rankings, and a formula on uservisits with a
    predicate the switch cannot evaluate (relaxed to TRUE, so the truth
    table and the master both do real work)."""
    def like(c):
        return (c * 3 + 1) % 7 == 0

    q1 = core.Pred("page_rank", "gt", page_rank_cut)
    uv = core.And((core.Pred("lang", "lt", 16),
                   core.Or((core.Pred("duration", "like", like, False),
                            core.Pred("ad_revenue", "gt", 150.0))),
                   core.Pred("source_ip", "ne", 0)))

    def uv_truth(t):
        import torch

        return ((u64(torch, t["lang"]) < 16)
                & (like(t["duration"]) | (t["ad_revenue"] > 150.0))
                & (u64(torch, t["source_ip"]) != 0))
    return [("rankings", ("page_rank",), q1,
             lambda t: t["page_rank"] > page_rank_cut),
            ("uservisits", ("lang", "duration", "ad_revenue", "source_ip"),
             uv, uv_truth)]


def block_form(name, S):
    """The launch count that pass 1 of TOP-N or DISTINCT (``name``) at
    B > 1 and S lanes goes to, as use_block_walk dispatches it: the block
    walk or the staged block kernel."""
    import torch

    from repro_torch.kernels import parallel as P

    walk = P.use_block_walk(S, torch.device("cuda"))
    return name + ("_block_walk" if walk else "_block")


def phase_main(torch, P, O):
    from repro_torch import core
    from repro_torch.core.encoding import take_rows
    from repro_torch.query import (QuerySpec, make_rankings, make_uservisits,
                                   run_query)

    table, secs = sync_time(lambda: make_uservisits(M_MAIN, seed=0))
    xs = table.cols["ad_revenue"]
    fs = table.cols["source_ip"]
    say("main", table="uservisits", rows=M_MAIN, bytes=sum(
        c.numel() * c.element_size() for c in table.cols.values()),
        build_s=round(secs, 3))
    rankings, secs = sync_time(lambda: make_rankings(M_RANKINGS, seed=1))
    say("main", table="rankings", rows=M_RANKINGS, bytes=sum(
        c.numel() * c.element_size() for c in rankings.cols.values()),
        build_s=round(secs, 3))

    # the truth, computed without the port: a stable top-N and torch.unique
    srt = torch.sort(xs, descending=True, stable=True)
    true_v, true_i = srt.values[:TOPN_N], srt.indices[:TOPN_N]
    f64 = fs.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    uniq, inv = torch.unique(f64, return_inverse=True)
    first = torch.full((uniq.numel(),), M_MAIN, dtype=torch.int64,
                       device="cuda").scatter_reduce(
        0, inv, torch.arange(M_MAIN, device="cuda"), "amin")
    say("main", distinct_values=uniq.numel())
    pts = torch.stack([table.cols[c].float() for c in SKY_COLS], -1)
    sky = skyline_sweep(torch, pts)
    truths = {q[2]["agg"]: having_truth(torch, table.cols[q[0]],
                                        table.cols[q[1]], q[2]["threshold"],
                                        q[2]["agg"])
              for q in (HAVING_COUNT, HAVING_SUM)}
    say("main", skyline_points=int(sky.sum()),
        having_count_keys=truths["count"][0].numel(),
        having_sum_keys=truths["sum"][0].numel())
    (join_t, join_rows_a, join_rows_b) = join_truth(torch, table, rankings)
    gb_keys, gb_sum, gb_count = groupby_truth(torch, table)
    cut = float(torch.quantile(rankings.cols["page_rank"], 0.9))
    filters = filter_formulas(core, cut)
    tabs = {"uservisits": table, "rankings": rankings}
    say("main", join_matches=join_t[0].numel(),
        join_rows_a=int(join_rows_a.sum()), join_rows_b=int(join_rows_b.sum()),
        groupby_keys=gb_keys.numel(), page_rank_cut=cut)

    def topn_ok(keep, name, out=None):
        v, i = core.master_complete_topn(xs, keep, TOPN_N) if out is None \
            else out
        check(torch.equal(v, true_v) and torch.equal(i, true_i),
              f"{name}: top-{TOPN_N} differs from the stable sort")
        check(bool(keep[true_i].all()), f"{name}: a top-N entry was pruned")

    def topn_codes_ok(r, name, tab):
        """TOP-N on a dictionary column, held to the reference's rule: the
        codes are ordered as f32, ties to the lower row, which is exact
        below 2^24 codes only (ROADMAP Queue 3: the dictionary of
        ad_revenue has 21 M entries). Prints how many of the N rows differ
        from the exact top-N."""
        import numpy as np

        keep, (v, i) = r["keep"], r["output"]
        check(bool(keep[true_i].all()), f"{name}: a top-N entry was pruned")
        kidx = torch.nonzero(keep).flatten()
        key = (take_rows(tab.col("ad_revenue").codes, kidx)
               .view(torch.int32).cpu().numpy().view(np.uint32)
               .astype(np.float32))
        order = np.argsort(-key, kind="stable")[:TOPN_DET["N"]]
        rows = kidx[torch.from_numpy(order).cuda()]
        check(torch.equal(i, rows) and torch.equal(v, xs[rows]),
              f"{name}: top-{TOPN_DET['N']} differs from the f32 order of "
              "the codes")
        say("main", path=name, rows_off_the_exact_top_n=int(
            (i != true_i[:TOPN_DET["N"]]).sum()))

    def skyline_ok(keep, name, out=None):
        if out is None:
            out = core.master_complete_skyline(pts, keep)
        check(torch.equal(out, sky), f"{name}: SKYLINE differs from the "
              "sort-and-sweep skyline")
        check(bool(keep[sky].all()), f"{name}: a skyline point was pruned")

    def having_ok(keep, name, agg, out=None):
        kname, vname, p = HAVING_COUNT if agg == "count" else HAVING_SUM
        want, rows = truths[agg]
        if out is None:
            out = core.master_complete_having(
                table.cols[kname], table.cols[vname], keep, p["threshold"],
                agg)
        check(out == want.tolist(), f"{name}: HAVING differs from bincount")
        check(bool(keep[rows].all()),
              f"{name}: a row of a qualifying key was pruned")

    def cms_ok(est, name):
        counts = torch.bincount(f64)
        check(bool((est >= counts[f64].float()).all()),
              f"{name}: a Count-Min estimate is below the true count")
        having_ok(est > HAVING_COUNT[2]["threshold"], name, "count")

    def distinct_ok(keep, name, out=None):
        if out is None:
            mask = core.master_complete_distinct(fs, keep)
            out = torch.unique(f64[mask])
        else:
            out = out.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        check(torch.equal(out, uniq), f"{name}: DISTINCT differs from unique")
        check(bool(keep[first].all()),
              f"{name}: a first occurrence was pruned")

    def join_ok(r, name):
        out = r["output"]
        check(len(out) == 3 and all(torch.equal(a, b)
                                    for a, b in zip(out, join_t)),
              f"{name}: JOIN differs from the sort-merge join")
        keep_a, keep_b = r["keep"][:M_MAIN], r["keep"][M_MAIN:]
        check(bool(keep_a[join_rows_a].all() and keep_b[join_rows_b].all()),
              f"{name}: a matching row was pruned")

    def groupby_ok(out, name, agg):
        keys = torch.tensor(list(out.keys()), dtype=torch.int64,
                            device="cuda")
        vals = torch.tensor(list(out.values()), dtype=torch.float64,
                            device="cuda")
        o = torch.argsort(keys)
        keys, vals = keys[o], vals[o]
        if not check(torch.equal(keys, gb_keys),
                     f"{name}: GROUP BY keys differ from bincount"):
            return
        if agg == "count":
            check(torch.equal(vals, gb_count.double()),
                  f"{name}: GROUP BY COUNT differs from bincount")
        else:
            rel = float(((vals - gb_sum).abs() / gb_sum.abs()).max())
            say("main", path=name, max_rel_err_vs_f64=rel)
            check(rel <= 1e-2, f"{name}: GROUP BY SUM off by {rel} relative")

    def groupby_traffic(name, traffic, slots, reported_pruned):
        """The true switch->master traffic (valid evictions and valid state
        slots) beside the pruned fraction the reference's keep reports."""
        say("main", path=name, true_traffic=traffic, slots=slots,
            true_forwarded_share=traffic / slots,
            true_pruned_fraction=1 - traffic / M_MAIN,
            reported_pruned_fraction=reported_pruned)

    def run_query_groupby_ok(r, agg):
        name = f"run_query_groupby_{agg}"
        groupby_ok(r["output"], name, agg)
        # keep = ~traffic, reproduced from the reference (ROADMAP Queue 3)
        groupby_traffic(name, int((~r["keep"]).sum()), r["total"],
                        r["pruned_fraction"])

    def engine_groupby_ok(r):
        name = "engine_two_pass_groupby"
        groupby_ok(core.master_complete_groupby(r, "count"), name, "count")
        traffic = int(r.emitted[2].sum()) + int(r.state.valid.sum())
        groupby_traffic(name, traffic,
                        r.emitted[2].numel() + r.state.valid.numel(),
                        1 - float(r.keep.float().mean()))

    def filter_ok(r, name, truth):
        check(torch.equal(r["output"], torch.nonzero(truth).flatten()),
              f"{name}: FILTER differs from a direct evaluation")
        check(bool(r["keep"][truth].all()),
              f"{name}: a matching row was pruned")

    # encoded copies of the table and the run layouts: set-up, not a path
    encoded, secs = sync_time(lambda: {
        "dict ad_revenue": table.encode("ad_revenue"),
        "dict source_ip": table.encode("source_ip"),
        "rle source_ip": table.encode("source_ip", rle=True)})
    say("main", encoded_tables=json.dumps(list(encoded)),
        ad_revenue_dictionary=encoded["dict ad_revenue"].col(
            "ad_revenue").encoding.size,
        source_ip_dictionary=encoded["dict source_ip"].col(
            "source_ip").encoding.size,
        source_ip_runs=encoded["rle source_ip"].col("source_ip").num_runs,
        build_s=round(secs, 3))
    rle_t, rle_d, rle_l = rle_layouts(torch)
    keeps = {}

    def like_plain(name, base, keep, tab):
        """keep equals the plain column's, and the decoded survivors of
        every column equal the plain rows."""
        check(torch.equal(keep, keeps[base]),
              f"{name}: keep differs from the plain column's")
        rows = tab.gather_decoded(keep)
        check(all(same(v, take_rows(
            table.cols[c], torch.nonzero(keep).flatten()))
            for c, v in rows.items()),
            f"{name}: decoded survivors differ from the plain rows")

    def remember(base, keep):
        keeps[base] = keep
        return keep

    def rle_topn_ok(r):
        head, tstar, keep = r
        flat = core.rle_expand(rle_t, rle_l, total=M_MAIN)
        scan = core.topn_det_prune(flat, **RLE_TOPN).keep
        check(torch.equal(keep, scan), "ops_rle_topn: the expanded mask "
              "differs from the flat ladder scan")
        srt = torch.sort(flat, descending=True, stable=True)
        v, i = core.master_complete_topn(flat, keep, RLE_TOPN["N"])
        check(torch.equal(v, srt.values[:RLE_TOPN["N"]])
              and torch.equal(i, srt.indices[:RLE_TOPN["N"]]),
              "ops_rle_topn: top-N differs from the stable sort")

    def rle_distinct_ok(r):
        run_keep, keep = r
        flat = core.rle_expand(rle_d, rle_l, total=M_MAIN)
        scan = core.distinct_prune(flat, **RLE_DISTINCT).keep
        check(torch.equal(keep, scan), "ops_rle_distinct: the expanded mask "
              "differs from the flat LRU scan")
        f = u64(torch, flat)
        out = torch.unique(f[core.master_complete_distinct(flat, keep)])
        check(torch.equal(out, torch.unique(f)),
              "ops_rle_distinct: DISTINCT differs from unique")

    def bloom_ok(keep, name):
        member = torch.isin(u64(torch, table.cols["dest_url"]),
                            u64(torch, rankings.cols["page_url"]
                                [:BLOOM_OPS_KEYS]))
        check(bool(keep[member].all()), f"{name}: a false negative")
        say("main", path=name, members=int(member.sum()),
            positives=int(keep.sum()))

    paths = {
        "run_query_topn": (
            lambda: run_query(QuerySpec("topn", ("ad_revenue",),
                                        dict(N=TOPN_N, **TOPN)), table),
            lambda r: topn_ok(r["keep"], "run_query_topn", r["output"]),
            lambda r: r["keep"], ("topn_pass1",)),
        "run_query_distinct": (
            lambda: run_query(QuerySpec("distinct", ("source_ip",),
                                        dict(policy="fifo", **DISTINCT)),
                              table),
            lambda r: distinct_ok(r["keep"], "run_query_distinct",
                                  r["output"]),
            lambda r: r["keep"], ("distinct_pass1",)),
        "engine_two_pass_topn": (
            lambda: core.engine_prune("topn_rand", xs, mode="two_pass",
                                      shards=SHARDS, **TOPN),
            lambda r: topn_ok(r.keep, "engine_two_pass_topn"),
            lambda r: r.keep, ("topn_pass1", "topn_apply")),
        "engine_two_pass_distinct": (
            lambda: core.engine_prune("distinct", fs, mode="two_pass",
                                      shards=SHARDS, policy="fifo",
                                      **DISTINCT),
            lambda r: distinct_ok(r.keep, "engine_two_pass_distinct"),
            lambda r: r.keep, ("distinct_pass1", "distinct_apply")),
        "ops_topn_prune_parallel": (
            lambda: O.topn_prune_parallel(xs, shards=SHARDS, block=256,
                                          **TOPN),
            lambda k: topn_ok(k, "ops_topn_prune_parallel"),
            lambda k: k, (block_form("topn_pass1", SHARDS), "topn_apply")),
        "ops_distinct_prune_parallel": (
            lambda: O.distinct_prune_parallel(fs, shards=SHARDS, block=256,
                                              **DISTINCT),
            lambda k: distinct_ok(k, "ops_distinct_prune_parallel"),
            lambda k: k, (block_form("distinct_pass1", SHARDS),
                          "distinct_apply")),
        "ops_topn_prune": (
            lambda: O.topn_prune(xs, block=256, **TOPN),
            lambda k: topn_ok(k, "ops_topn_prune"),
            lambda k: k, (block_form("topn_pass1", 1), "topn_onehot_fixup")),
        "ops_distinct_prune": (
            lambda: O.distinct_prune(fs, block=256, **DISTINCT),
            lambda k: distinct_ok(k, "ops_distinct_prune"),
            lambda k: k, (block_form("distinct_pass1", 1),)),
        "run_query_skyline": (
            lambda: run_query(QuerySpec("skyline", SKY_COLS, SKYLINE), table),
            lambda r: skyline_ok(r["keep"], "run_query_skyline", r["output"]),
            lambda r: r["keep"], ("skyline_pass1",)),
        "engine_two_pass_skyline": (
            lambda: core.engine_prune("skyline", pts, mode="two_pass",
                                      shards=SHARDS, **SKYLINE),
            lambda r: skyline_ok(r.keep, "engine_two_pass_skyline"),
            lambda r: r.keep, ("skyline_pass1", "skyline_apply")),
        "ops_skyline_prune_parallel": (
            lambda: O.skyline_prune_parallel(pts, shards=SHARDS, block=256,
                                             **SKYLINE),
            lambda k: skyline_ok(k, "ops_skyline_prune_parallel"),
            lambda k: k, ("skyline_pass1", "skyline_apply")),
        "ops_skyline_prune": (
            lambda: O.skyline_prune(pts, block=256, **SKYLINE),
            lambda k: skyline_ok(k, "ops_skyline_prune"),
            lambda k: k, ("skyline_pass1",)),
        "run_query_having_count": (
            lambda: run_query(QuerySpec("having", HAVING_COUNT[:2],
                                        HAVING_COUNT[2]), table),
            lambda r: having_ok(r["keep"], "run_query_having_count", "count",
                                r["output"]),
            lambda r: r["keep"], ("cms_build", "cms_query")),
        "run_query_having_sum": (
            lambda: run_query(QuerySpec("having", HAVING_SUM[:2],
                                        HAVING_SUM[2]), table),
            lambda r: having_ok(r["keep"], "run_query_having_sum", "sum",
                                r["output"]),
            lambda r: r["keep"], ("cms_build", "cms_query")),
        "engine_two_pass_having": (
            lambda: core.engine_prune(
                "having", table.cols[HAVING_COUNT[0]],
                table.cols[HAVING_COUNT[1]], mode="two_pass", shards=SHARDS,
                **HAVING_COUNT[2]),
            lambda r: having_ok(r.keep, "engine_two_pass_having", "count"),
            lambda r: r.keep, ("cms_build", "cms_query")),
        "ops_cms": (
            lambda: O.cms_query(O.cms_build(
                fs, torch.ones(M_MAIN, dtype=torch.float32, device="cuda"),
                **CMS_OPS), fs),
            lambda est: cms_ok(est, "ops_cms"),
            lambda est: est > HAVING_COUNT[2]["threshold"],
            ("cms_build", "cms_query")),
        "run_query_join": (
            lambda: run_query(QuerySpec("join", ("dest_url", "page_url"),
                                        JOIN), (table, rankings)),
            lambda r: join_ok(r, "run_query_join"),
            lambda r: r["keep"], ("bloom_build", "bloom_query")),
        "ops_bloom": (
            lambda: O.bloom_query(O.bloom_build(
                rankings.cols["page_url"][:BLOOM_OPS_KEYS], **BLOOM_OPS),
                table.cols["dest_url"], num_hashes=BLOOM_OPS["num_hashes"]),
            lambda k: bloom_ok(k, "ops_bloom"),
            lambda k: k, ("bloom_build_global", "bloom_query")),
        **{f"run_query_filter_{tname}": (
            lambda tname=tname, cols=cols, f=f: run_query(
                QuerySpec("filter", cols, dict(formula=f)), tabs[tname]),
            lambda r, tname=tname, truth=truth: filter_ok(
                r, f"run_query_filter_{tname}", truth(tabs[tname].cols)),
            lambda r: r["keep"], ())
            for tname, cols, f, truth in filters},
        **{f"run_query_groupby_{agg}": (
            lambda agg=agg: run_query(QuerySpec(
                "groupby", ("source_ip", "ad_revenue"),
                dict(agg=agg, **GROUPBY)), table),
            lambda r, agg=agg: run_query_groupby_ok(r, agg),
            lambda r: r["keep"], ("groupby_pass1",))
            for agg in ("sum", "count")},
        "engine_two_pass_groupby": (
            lambda: core.engine_prune("groupby", fs, xs, mode="two_pass",
                                      shards=SHARDS, agg="count", **GROUPBY),
            engine_groupby_ok,
            lambda r: r.keep, ("groupby_pass1",)),
    }
    paths.update({
        "run_query_topn_det": (
            lambda: run_query(QuerySpec("topn", ("ad_revenue",),
                                        dict(mode="det", **TOPN_DET)), table),
            lambda r: topn_ok(remember("topn_det", r["keep"]),
                              "run_query_topn_det", r["output"]),
            lambda r: r["keep"], ("topn_det_pass1",)),
        "run_query_topn_det_dict": (
            lambda: run_query(QuerySpec("topn", ("ad_revenue",),
                                        dict(mode="det", **TOPN_DET)),
                              encoded["dict ad_revenue"]),
            lambda r: (topn_codes_ok(r, "run_query_topn_det_dict",
                                     encoded["dict ad_revenue"]),
                       like_plain("run_query_topn_det_dict", "topn_det",
                                  r["keep"], encoded["dict ad_revenue"])),
            lambda r: r["keep"], ("topn_det_pass1",)),
        "run_query_distinct_lru": (
            lambda: run_query(QuerySpec("distinct", ("source_ip",),
                                        DISTINCT), table),
            lambda r: distinct_ok(remember("distinct_lru", r["keep"]),
                                  "run_query_distinct_lru", r["output"]),
            lambda r: r["keep"], ("distinct_pass1_lru",)),
        **{f"run_query_distinct_lru_{kind}": (
            lambda kind=kind: run_query(QuerySpec("distinct", ("source_ip",),
                                                  DISTINCT),
                                        encoded[f"{kind} source_ip"]),
            lambda r, kind=kind: (
                distinct_ok(r["keep"], f"run_query_distinct_lru_{kind}",
                            r["output"]),
                like_plain(f"run_query_distinct_lru_{kind}", "distinct_lru",
                           r["keep"], encoded[f"{kind} source_ip"])),
            lambda r: r["keep"], ("distinct_pass1_lru",))
            for kind in ("dict", "rle")},
        "engine_two_pass_topn_det": (
            lambda: core.engine_prune("topn_det", xs, mode="two_pass",
                                      shards=SHARDS, **TOPN_DET),
            lambda r: topn_ok(remember("engine_topn_det", r.keep),
                              "engine_two_pass_topn_det"),
            lambda r: r.keep, ("topn_det_pass1",)),
        "engine_two_pass_topn_det_dict": (
            lambda: core.engine_prune(
                "topn_det", encoded["dict ad_revenue"].col("ad_revenue").codes,
                encoding=encoded["dict ad_revenue"].col(
                    "ad_revenue").encoding, mode="two_pass", shards=SHARDS,
                **TOPN_DET),
            lambda r: (topn_ok(r.keep, "engine_two_pass_topn_det_dict"),
                       check(torch.equal(r.keep, keeps["engine_topn_det"]),
                             "engine_two_pass_topn_det_dict: keep differs "
                             "from the plain column's")),
            lambda r: r.keep, ("topn_det_pass1",)),
        "engine_two_pass_distinct_lru": (
            lambda: core.engine_prune("distinct", fs, mode="two_pass",
                                      shards=SHARDS, **DISTINCT),
            lambda r: distinct_ok(remember("engine_distinct_lru", r.keep),
                                  "engine_two_pass_distinct_lru"),
            lambda r: r.keep, ("distinct_pass1_lru", "distinct_apply")),
        "engine_two_pass_distinct_lru_dict": (
            lambda: core.engine_prune(
                "distinct", encoded["dict source_ip"].col("source_ip").codes,
                encoding=encoded["dict source_ip"].col(
                    "source_ip").encoding, mode="two_pass", shards=SHARDS,
                **DISTINCT),
            lambda r: (distinct_ok(r.keep,
                                   "engine_two_pass_distinct_lru_dict"),
                       check(torch.equal(r.keep,
                                         keeps["engine_distinct_lru"]),
                             "engine_two_pass_distinct_lru_dict: keep "
                             "differs from the plain column's")),
            lambda r: r.keep, ("distinct_pass1_lru", "distinct_apply")),
        "ops_rle_topn": (
            lambda: (lambda h, t: (h, t, O.rle_expand_mask(
                h, t, rle_l, M_MAIN)))(*O.rle_topn_prune(rle_t, rle_l,
                                                         **RLE_TOPN)),
            rle_topn_ok, lambda r: r[2], ("rle_topn_det",)),
        "ops_rle_distinct": (
            lambda: (lambda k: (k, O.rle_expand_mask(k, None, rle_l,
                                                     M_MAIN)))(
                O.rle_distinct_prune(rle_d, **RLE_DISTINCT)),
            rle_distinct_ok, lambda r: r[1], ("distinct_pass1_lru",)),
    })
    totals = {k.name: 0 for k in P.KERNELS}
    answers = {}
    for name, (run, verify, keep_of, needs) in paths.items():
        P.reset_launch_counts()
        res, secs = sync_time(run)
        if name in MESH_QUERY_PATHS:
            answers[name] = res["output"]
        counts = {k.name: k.launches for k in P.KERNELS}
        for k, n in counts.items():
            totals[k] += n
        keep = keep_of(res)
        verify(res)
        for k in needs:
            check(counts[k] > 0, f"{name}: kernel {k} was never launched")
        # the same call again, as a repeated query meets it: the first call
        # of a path can pay one-time costs (allocations of new sizes)
        _, again = sync_time(run)
        say("main", path=name, s=round(secs, 4), s_again=round(again, 4),
            pruned=round(1 - float(keep.float().mean()), 6),
            launches=json.dumps(counts, separators=(",", ":")))
    return (table, rankings, pts, totals, encoded, (rle_t, rle_l), paths,
            answers)


# --------------------------------------------------------------- phase mesh
# mesh mode on the one card: the engine calls of section 5 at S = SHARDS on
# three meshes, (a) default_mesh(), one position; (b) that position in a
# one-rank NCCL group, so that NCCL's all-gather runs on the card; (c)
# MESH_POSITIONS positions on the card, so that every pass runs on lane
# sub-ranges and every apply with its lane base
MESH_PASS2 = ("master", "mesh", "auto")
MESH_POSITIONS = 8
# phase main's run_query paths whose answers a mesh run must give, one a
# query kind (GROUP BY COUNT: the f32 SUM partials add in another order
# when the lanes split)
MESH_QUERY_PATHS = ("run_query_topn", "run_query_distinct",
                    "run_query_skyline", "run_query_having_count",
                    "run_query_groupby_count", "run_query_join",
                    "run_query_filter_uservisits")
MESH_STREAM = ("distinct lru", 4)   # the PruneStream call, its merge period
# the pass-2 kernels: launched once an apply (a chunk of one), every other
# kernel of an engine call once a pass 1 of a position
MESH_APPLY_KERNELS = ("topn_apply", "distinct_apply", "skyline_apply",
                      "cms_query")
MESH_PATH_KERNELS = ("topn_pass1", "topn_apply", "topn_det_pass1",
                     "distinct_pass1", "distinct_pass1_lru",
                     "distinct_apply", "skyline_pass1", "skyline_apply",
                     "cms_build", "cms_query", "groupby_pass1", "bloom_query",
                     "distinct_pass1_batch_lru")


def same_state(torch, a, b) -> bool:
    """Two states (dataclasses, tuples of tensors or None) bit for bit:
    every float by its bits (torch.equal holds no NaN equal)."""
    def bits(t):
        if t.dtype == torch.float32:
            return t.contiguous().view(torch.int32)
        if t.dtype == torch.uint32:
            return t.contiguous().view(torch.int32)
        return t

    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(bits(a), bits(b))))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_state(torch, x, y)
                                        for x, y in zip(a, b))
    fields = [f for f in vars(a) if isinstance(getattr(a, f), torch.Tensor)]
    return all(same_state(torch, getattr(a, f), getattr(b, f))
               for f in fields)


def counted(P, fn):
    """(fn()'s result, its wall seconds, {kernel: launches} of that run
    alone): every launch count set to 0 just before fn and read just
    after it."""
    P.reset_launch_counts()
    out, secs = sync_time(fn)
    return out, secs, {k.name: k.launches for k in P.KERNELS if k.launches}


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def mesh_launches(base: dict, D: int, resident: bool, chunks: int) -> dict:
    """The launches a mesh call must make, from its two_pass's at the same
    S (one pass 1 and one whole apply): each pass-1 kernel once a position,
    each apply kernel once a chunk on each position that applies (all D
    when pass 2 is resident, the master alone else)."""
    return {k: v * ((D if resident else 1) * chunks
                    if k in MESH_APPLY_KERNELS else D)
            for k, v in base.items()}


def mesh_engine_calls(torch, P, table, meshes, total):
    """Each engine call of section 5 at pass2 master, mesh and auto on each
    mesh: keep, merged state and emissions bit for bit against two_pass at
    S = SHARDS; the report's counts against the masks (entries kept), one
    merge collective, and the gathered bytes (S lanes' states, times the
    positions when pass 2 is resident); the launches of the call's first
    run alone against ``mesh_launches``, added to ``total``; the wall time
    of each call, first and again, against two_pass's (warm: after one
    call)."""
    from repro_torch import core

    block = core.engine.DEFAULT_MESH_APPLY_BLOCK
    n = -(-M_MAIN // SHARDS)
    ok = True
    for name, algo, cols, params in ENGINE_CALLS:
        streams = engine_streams(torch, table, algo, cols)

        def two_pass():
            return core.engine_prune(algo, *streams, mode="two_pass",
                                     shards=SHARDS, **params)

        two_pass()
        two, two_s, base = counted(P, two_pass)
        shipped = two.report.counters["state_bytes_shipped"]
        chunks = (-(-n // block) if core.engine._SPECS[algo].chunkable
                  and block < n else 1)
        for mname, mesh in meshes:
            D = mesh.shape[mesh.axis]
            for p2 in MESH_PASS2:
                def call():
                    return core.engine_prune(algo, *streams, mode="mesh",
                                             shards=SHARDS, mesh=mesh,
                                             pass2=p2, **params)

                before = mesh.collectives
                res, secs, counts = counted(P, call)
                gathers = mesh.collectives - before
                add_counts(total, counts)
                _, again = sync_time(call)
                resident = res.keep.ndim == 2
                keep = (core.unshard_mask(res.keep, M_MAIN, mesh)
                        if resident else res.keep)
                c = res.report.counters
                good = check(same(keep, two.keep), f"mesh: {name} {mname} "
                             f"pass2={p2} keep differs from two_pass")
                good &= check(same_state(torch, res.state, two.state),
                              f"mesh: {name} {mname} pass2={p2} merged "
                              "state differs from two_pass's")
                good &= check(same_state(torch, res.emitted, two.emitted),
                              f"mesh: {name} {mname} pass2={p2} emissions "
                              "differ from two_pass's")
                good &= check(
                    c["entries_kept"] == int(keep.sum())
                    and c["merge_collective_count"] == 1
                    and c["state_bytes_shipped"]
                    == shipped * (D if resident else 1)
                    and gathers > 0,
                    f"mesh: {name} {mname} pass2={p2} counts differ from "
                    "the masks")
                want = mesh_launches(base, D, resident, chunks)
                good &= check(counts == want, f"mesh: {name} {mname} "
                              f"pass2={p2} launched {counts}, not {want}")
                ok &= good
                say("mesh", call=json.dumps(name), mesh=mname, positions=D,
                    pass2=p2, placed="mesh" if resident else "master",
                    s=round(secs, 5), s_again=round(again, 5),
                    two_pass_s=round(two_s, 5),
                    gathered_bytes=c["state_bytes_shipped"],
                    collectives=gathers, ok=good,
                    launches=json.dumps(counts, separators=(",", ":")))
    return ok


def mesh_query_specs(QuerySpec, table, rankings) -> dict:
    """(spec, tables) of each of phase main's MESH_QUERY_PATHS."""
    from repro_torch import core

    uv_filter = filter_formulas(core, 0.0)[1]
    return {
        "run_query_topn": (QuerySpec("topn", ("ad_revenue",),
                                     dict(N=TOPN_N, **TOPN)), table),
        "run_query_distinct": (QuerySpec("distinct", ("source_ip",),
                                         dict(policy="fifo", **DISTINCT)),
                               table),
        "run_query_skyline": (QuerySpec("skyline", SKY_COLS, SKYLINE), table),
        "run_query_having_count": (QuerySpec("having", HAVING_COUNT[:2],
                                             HAVING_COUNT[2]), table),
        "run_query_groupby_count": (QuerySpec(
            "groupby", ("source_ip", "ad_revenue"),
            dict(agg="count", **GROUPBY)), table),
        "run_query_join": (QuerySpec("join", ("dest_url", "page_url"), JOIN),
                           (table, rankings)),
        "run_query_filter_uservisits": (QuerySpec(
            "filter", uv_filter[1], dict(formula=uv_filter[2])), table),
    }


def mesh_queries(torch, P, table, rankings, answers, total):
    """One run_query a query kind on mesh (c)'s workers (axis "data"), each
    answer against phase main's; then one run_queries group whose resident
    wave is one gather. Each run's launches alone are added to ``total``;
    JOIN's must have built and queried its Bloom filters on the card."""
    from repro_torch import core
    from repro_torch.query import QuerySpec, run_queries, run_query

    specs = mesh_query_specs(QuerySpec, table, rankings)
    ok = True
    for name in MESH_QUERY_PATHS:
        spec, tabs = specs[name]
        mesh = core.Mesh((torch.device("cuda", 0),) * MESH_POSITIONS,
                         axis="data")
        r, secs, counts = counted(
            P, lambda: run_query(spec, tabs, mesh=mesh))
        add_counts(total, counts)
        good = check(same_answer(torch, r["output"], answers[name]),
                     f"mesh: {name} with a mesh differs from phase main's "
                     "answer")
        if name == "run_query_join":
            good &= check(counts.get("bloom_query", 0) > 0 and (
                counts.get("bloom_build", 0)
                + counts.get("bloom_build_global", 0)) > 0,
                "mesh: JOIN built or queried no Bloom filter on the card")
        ok &= good
        say("mesh", path=name, workers=MESH_POSITIONS, s=round(secs, 4),
            pruned=round(r["pruned_fraction"], 6),
            collectives=mesh.collectives, ok=good,
            launches=json.dumps(counts, separators=(",", ":")))
    specs = [s for s in batch_specs(QuerySpec)
             if (s.kind, s.params.get("policy")) == ("distinct", "lru")]
    mesh = core.Mesh((torch.device("cuda", 0),) * MESH_POSITIONS,
                     axis="data")
    out, secs, counts = counted(
        P, lambda: run_queries(specs, table, mesh=mesh))
    add_counts(total, counts)
    f64 = table.cols["source_ip"].view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    uniq = torch.unique(f64)
    good = check(mesh.collectives == 1, f"mesh: run_queries' group took "
                 f"{mesh.collectives} gathers, not one")
    for spec, r in zip(specs, out):
        got = r["output"].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        good &= check(torch.equal(got, uniq), f"mesh: run_queries {spec} "
                      "answer differs from unique")
    say("mesh", path="run_queries", queries=len(specs), s=round(secs, 4),
        collectives=mesh.collectives, ok=good,
        launches=json.dumps(counts, separators=(",", ":")))
    return ok & good


def same_answer(torch, a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and bool(torch.equal(a, b)))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_answer(torch, x, y)
                                        for x, y in zip(a, b))
    return a == b


def mesh_stream_and_plan(torch, P, table, total):
    """A PruneStream on mesh (c), close() against one-shot two_pass on the
    lane view; and execute_plan of a mesh plan, whose keep comes back flat
    and equal to two_pass's. The references run first; each mesh run's
    launches alone are added to ``total``."""
    from repro_torch import core

    name, K = MESH_STREAM
    _, algo, cols, params = next(c for c in ENGINE_CALLS if c[0] == name)
    streams = engine_streams(torch, table, algo, cols)
    sizes = stream_sizes()
    lv, valid, arrival = core.lane_view(algo, streams, sizes, SHARDS,
                                        **params)
    lone = core.engine_prune(algo, *lv, mode="two_pass", shards=SHARDS,
                             obs="off", **params)
    mesh = core.Mesh((torch.device("cuda", 0),) * MESH_POSITIONS)
    s = core.PruneStream(algo, shards=SHARDS, mesh=mesh, merge_every=K,
                         obs="counters", **params)

    def fold_all():
        lo = 0
        for b in sizes:
            s.fold(*(x[lo:lo + b] for x in streams))
            lo += b
        return s.close()

    res, wall, counts = counted(P, fold_all)
    add_counts(total, counts)
    ok = check(same(res.keep[arrival[valid]], lone.keep[valid]),
               f"mesh: PruneStream {name} close() differs from one-shot "
               "two_pass on the lane view")
    ok &= check(mesh.collectives == res.stats["merges"], "mesh: the stream "
                "took another count of gathers than merges")
    say("mesh", path="PruneStream", call=json.dumps(name), merge_every=K,
        positions=MESH_POSITIONS, batches=res.stats["batches"],
        merges=res.stats["merges"], stream_s=round(wall, 4),
        gathered_bytes=res.report.counters["state_bytes_shipped"], ok=ok,
        launches=json.dumps(counts, separators=(",", ":")))
    for name, algo, cols, params in ENGINE_CALLS[:4]:
        streams = engine_streams(torch, table, algo, cols)
        two = core.engine_prune(algo, *streams, mode="two_pass",
                                shards=SHARDS, obs="off", **params)
        plan = core.Plan(mode="mesh", shards=SHARDS, pass2="mesh",
                         num_devices=1)
        got, secs, counts = counted(P, lambda: core.execute_plan(
            algo, *streams, plan=plan, obs="off", **params))
        add_counts(total, counts)
        good = check(got.keep.shape == (M_MAIN,) and same(got.keep, two.keep),
                     f"mesh: execute_plan({plan.key()}) {name} keep is not "
                     "two_pass's flat keep")
        ok &= good
        say("mesh", path="execute_plan", call=json.dumps(name),
            plan=plan.key(), s=round(secs, 5), ok=good)
    return ok


def phase_mesh(torch, P, table, rankings, answers):
    """Mesh mode on the card (module comment above MESH_PASS2): the engine
    calls on meshes (a), (b) and (c); a run_query a query kind and a
    run_queries group on (c)'s workers; a PruneStream on (c); execute_plan
    of a mesh plan. Launch counts are set to 0 just before each mesh run
    and read just after it (``counted``), never around a reference run;
    their sum must hold every kernel of the mesh paths. Mesh (a) is built
    before any process group exists, so it is default_mesh's card branch
    with no group; the one-rank NCCL group (b) meets through a HashStore
    and is destroyed at the end."""
    import torch.distributed as dist

    from repro_torch import core

    card = torch.device("cuda", 0)
    total: dict = {}
    alone = core.default_mesh()
    ok = check(alone.devices == (card,) and alone.group is None,
               "mesh: default_mesh() is not one position on the card "
               "without a group")
    # NCCL's bootstrap of the one rank stays on the loopback device
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        nccl = core.Mesh((card,), group=dist.group.WORLD)
        ok &= check(dist.get_backend(nccl.group) == "nccl",
                    "mesh: mesh (b)'s group is not NCCL")
        meshes = (("a default_mesh", alone), ("b nccl", nccl),
                  ("c 8 positions", core.Mesh((card,) * MESH_POSITIONS)))
        ok &= mesh_engine_calls(torch, P, table, meshes, total)
    finally:
        dist.destroy_process_group()
    ok &= mesh_queries(torch, P, table, rankings, answers, total)
    ok &= mesh_stream_and_plan(torch, P, table, total)
    for k in MESH_PATH_KERNELS:
        ok &= check(total.get(k, 0) > 0,
                    f"mesh: kernel {k} was never launched by a mesh run")
    say("mesh", card=json.dumps(card_line()), ok=ok,
        launches=json.dumps(total, separators=(",", ":")))


# -------------------------------------------------------------- phase batch
# run_queries groups on the 2^25-row uservisits table, (d, w, seed) of each
# member: TOP-N rand on ad_revenue (N = TOPN_N), DISTINCT LRU and FIFO on
# source_ip, GROUP BY SUM of ad_revenue by source_ip; then TOP-N det
# (N, w), HAVING COUNT by source_ip (threshold, rows, width) and two
# SKYLINEs (w) through engine_prune_batch
BATCH_TOPN = ((256, 4, 1), (512, 8, 0), (1024, 6, 5), (768, 8, 9))
BATCH_DISTINCT = ((4096, 4, 0), (2048, 2, 3), (4096, 3, 5))
BATCH_GROUPBY = ((4096, 4, 0), (4096, 2, 2), (4096, 3, 4))
BATCH_TOPN_DET = ((100, 8), (50, 6), (250, 8))
BATCH_HAVING = ((100_000, 3, 4096), (50_000, 2, 2048), (200_000, 4, 4096))
BATCH_SKYLINE_W = (8, 6)
BATCH_PREFIX = 1 << 16          # entries of the batched walks' plain check
BATCH_PLAIN_Q = 2               # queries of each wave the plain check takes


def batch_specs(QuerySpec):
    specs = [QuerySpec("topn", ("ad_revenue",), dict(d=d, w=w, N=TOPN_N,
                                                     seed=sd))
             for d, w, sd in BATCH_TOPN]
    for policy in ("lru", "fifo"):
        specs += [QuerySpec("distinct", ("source_ip",),
                            dict(d=d, w=w, seed=sd, policy=policy))
                  for d, w, sd in BATCH_DISTINCT]
    specs += [QuerySpec("groupby", ("source_ip", "ad_revenue"),
                        dict(d=d, w=w, seed=sd))
              for d, w, sd in BATCH_GROUPBY]
    specs += [QuerySpec("topn", ("ad_revenue",), dict(mode="det", N=n, w=w))
              for n, w in BATCH_TOPN_DET]
    specs += [QuerySpec("having", HAVING_COUNT[:2],
                        dict(threshold=t, rows=r, width=wd, agg="count"))
              for t, r, wd in BATCH_HAVING]
    return specs


def _walk_wave(members):
    """(d, w, seeds, dcap, wcap) of a wave of (d, w, seed) members."""
    d, w, seeds = (list(x) for x in zip(*members))
    return d, w, seeds, max(d), max(w)


def batch_walks(BW):
    """name -> (the batched walk on (stream, S), its queries' serial walks
    on (stream, S), the wave's members, column)."""
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels.groupby_scan import groupby_pass1_kernel

    def topn(v, S, wave=_walk_wave(BATCH_TOPN)):
        d, w, sd, dc, wc = wave
        return BW.topn_pass1_batch(v, d=d, w=w, seeds=sd, shards=S, dcap=dc,
                                   wcap=wc)

    def distinct(v, S, policy, wave=_walk_wave(BATCH_DISTINCT)):
        d, w, sd, dc, wc = wave
        return BW.distinct_pass1_batch(v, d=d, w=w, seeds=sd, shards=S,
                                       dcap=dc, wcap=wc, policy=policy)

    def groupby(kv, S, wave=_walk_wave(BATCH_GROUPBY)):
        d, w, sd, dc, wc = wave
        return BW.groupby_pass1_batch(kv[0], kv[1], None, d=d, w=w, seeds=sd,
                                      agg="sum", shards=S, dcap=dc, wcap=wc)

    out = {"topn_pass1_batch": (
        topn, lambda v, S: [P.topn_shard_states_kernel(
            v, d=a, w=b, shards=S, block=1, seed=c, family="engine")
            for a, b, c in BATCH_TOPN], BATCH_TOPN, "ad_revenue")}
    for policy, name in (("lru", "distinct_pass1_batch_lru"),
                         ("fifo", "distinct_pass1_batch")):
        out[name] = (
            lambda v, S, p=policy: distinct(v, S, p),
            lambda v, S, p=policy: [P.distinct_shard_states_kernel(
                v, d=a, w=b, shards=S, block=1, seed=c, policy=p)
                for a, b, c in BATCH_DISTINCT], BATCH_DISTINCT, "source_ip")
    out["groupby_pass1_batch"] = (
        groupby, lambda kv, S: [groupby_pass1_kernel(
            kv[0], kv[1], None, d=a, w=b, agg="sum", seed=c, shards=S)
            for a, b, c in BATCH_GROUPBY], BATCH_GROUPBY, "source_ip")
    return out


def batch_host_jobs(cols, torch):
    """HostPlain jobs: each batched walk's plain version on the first
    BATCH_PREFIX entries (the one-lane B = 1 rule) for its wave's first
    BATCH_PLAIN_Q members."""
    from repro_torch.kernels import batch_walks as BW

    keys = cols["distinct_pass1"][:BATCH_PREFIX].clone()
    revenue = cols["topn_pass1"][:BATCH_PREFIX].clone()
    jobs = {}
    for name, (_, _, members, _) in batch_walks(BW).items():
        d, w, sd, dc, wc = _walk_wave(members[:BATCH_PLAIN_Q])
        if name == "topn_pass1_batch":
            fn = (lambda v, d=d, w=w, sd=sd, dc=dc, wc=wc:
                  BW.topn_pass1_batch(v, d=d, w=w, seeds=sd, shards=1,
                                      dcap=dc, wcap=wc))
            args = (revenue,)
        elif name == "groupby_pass1_batch":
            fn = (lambda k, v, d=d, w=w, sd=sd, dc=dc, wc=wc:
                  BW.groupby_pass1_batch(k, v, None, d=d, w=w, seeds=sd,
                                         agg="sum", shards=1, dcap=dc,
                                         wcap=wc))
            args = (keys, revenue)
        else:
            policy = "lru" if name.endswith("_lru") else "fifo"
            fn = (lambda v, d=d, w=w, sd=sd, dc=dc, wc=wc, p=policy:
                  BW.distinct_pass1_batch(v, d=d, w=w, seeds=sd, shards=1,
                                          dcap=dc, wcap=wc, policy=p))
            args = (keys,)
        jobs[(name, 1, 1)] = (fn, args)
    return jobs


def same_result(torch, a, b) -> bool:
    """Two run_query results alike: keep, forwarded and output."""
    if a["forwarded"] != b["forwarded"] or not same(a["keep"], b["keep"]):
        return False
    x, y = a["output"], b["output"]
    if isinstance(x, torch.Tensor):
        return same(x, y)
    if isinstance(x, tuple):
        return all(same(p, q) for p, q in zip(x, y))
    return x == y


def batch_chain_ms(torch, name, v, members, clock_hz):
    """The longest dependent chain of a batched walk's work on this stream,
    in ms: the costliest (query, row) segment's, as the serial walks' bounds
    count it (REG_STEP_CYCLES a step on a row in registers). TOP-N: the
    inserts of the segment's entries in stream order (running_inserts);
    DISTINCT: its entries whose key differs from the segment predecessor's
    (a repeat needs no step); GROUP BY SUM: those, and one fold
    (FADD_CYCLES) for each repeat. The segments come from a stable sort
    here, bookkeeping of this measurement."""
    from repro_torch.core.hashing import as_u32, hash_mod

    worst = 0.0
    for d, w, seed in members:
        if name == "topn_pass1_batch":
            idx = torch.arange(v.numel(), device=v.device)
            seg = hash_mod(idx, d, seed)
            order = torch.sort(seg, stable=True).indices
            ss = seg[order]
            counts = torch.bincount(ss, minlength=d)
            starts = torch.cumsum(counts, 0) - counts
            mat = torch.full((d, int(counts.max())), float("nan"),
                             device=v.device)
            mat[ss, torch.arange(v.numel(), device=v.device) - starts[ss]] \
                = v[order]
            cycles = float(running_inserts(torch, mat, w).sum(1).max()) \
                * REG_STEP_CYCLES
        else:
            seg = hash_mod(v, d, seed)
            order = torch.sort(seg, stable=True).indices
            ss, kk = seg[order], as_u32(v)[order]
            new = torch.ones_like(ss, dtype=torch.bool)
            new[1:] = (ss[1:] != ss[:-1]) | (kk[1:] != kk[:-1])
            rep = FADD_CYCLES if name == "groupby_pass1_batch" else 0
            cost = torch.where(new, float(REG_STEP_CYCLES), float(rep))
            cycles = float(torch.bincount(ss, weights=cost.double(),
                                          minlength=d).max())
        worst = max(worst, cycles)
    return worst / clock_hz * 1e3


def phase_batch(torch, P, table, pts, clock_hz, host):
    """Multi-query batching on the 2^25-row table. ``run_queries`` over
    groups of TOP-N rand, DISTINCT LRU and FIFO, GROUP BY SUM, TOP-N det
    and HAVING COUNT is the batch path: every launch count is zeroed just
    before it and read just after, and each batched walk must have run.
    Every member's result equals its serial ``run_query``; the two SKYLINEs
    run through ``engine_prune_batch`` (their completion is O(k^2)) against
    serial ``engine_prune``; ``engine_prune_batch`` two_pass at S = 128
    equals serial two_pass. Each batched walk is bit-identical to its Q
    serial walk launches on the whole column at S = 1 and 128, and to its
    plain version on the first BATCH_PREFIX entries (HostPlain). Prints
    the batch's wall time beside the serial loop's, and each batched walk's
    device time beside its Q serial launches'; returns the kernels line's
    rows of the batched walks."""
    from repro_torch import core
    from repro_torch.kernels import batch_walks as BW
    from repro_torch.query import QuerySpec, run_queries, run_query

    specs = batch_specs(QuerySpec)
    P.reset_launch_counts()
    res, secs = sync_time(lambda: run_queries(specs, table))
    counts = {k.name: k.launches for k in P.KERNELS}
    walks = batch_walks(BW)
    for k in tuple(walks) + ("topn_det_pass1", "cms_build", "cms_query"):
        check(counts[k] > 0, f"batch: kernel {k} was never launched by "
              "run_queries")
    _, again = sync_time(lambda: run_queries(specs, table))
    serial, serial_s = sync_time(lambda: [run_query(s, table) for s in specs])
    _, serial_again = sync_time(lambda: [run_query(s, table)
                                         for s in specs])
    for spec, a, b in zip(specs, res, serial):
        check(same_result(torch, a, b), f"batch: run_queries member "
              f"{spec.kind} {spec.params} differs from its run_query")
    say("batch", path="run_queries", queries=len(specs), groups=6,
        s=round(secs, 4), s_again=round(again, 4),
        serial_s=round(serial_s, 4), serial_again=round(serial_again, 4),
        launches=json.dumps(counts, separators=(",", ":")))

    qs = [dict(w=w) for w in BATCH_SKYLINE_W]
    rb, secs = sync_time(lambda: core.engine_prune_batch(
        "skyline", qs, pts, mode="scan"))
    for i, q in enumerate(qs):
        s = core.engine_prune("skyline", pts, mode="scan", **q)
        check(same(rb.keep[i], s.keep), f"batch: SKYLINE w={q['w']} keep "
              "differs from engine_prune")
    say("batch", path="engine_prune_batch skyline scan", s=round(secs, 4))

    xs, fs = table.cols["ad_revenue"], table.cols["source_ip"]
    for algo, v, members, extra in (
            ("topn_rand", xs, BATCH_TOPN, {}),
            ("distinct", fs, BATCH_DISTINCT, {"policy": "lru"})):
        qs = [dict(d=d, w=w, seed=sd, **extra) for d, w, sd in members]
        rb, secs = sync_time(lambda: core.engine_prune_batch(
            algo, qs, v, mode="two_pass", shards=SHARDS))
        loop, loop_s = sync_time(lambda: [core.engine_prune(
            algo, v, mode="two_pass", shards=SHARDS, **q) for q in qs])
        for i, (q, s) in enumerate(zip(qs, loop)):
            check(same(rb.keep[i], s.keep), f"batch: two_pass S={SHARDS} "
                  f"{algo} {q} keep differs from engine_prune")
        say("batch", path=f"engine_prune_batch {algo} two_pass",
            S=SHARDS, s=round(secs, 4), serial_s=round(loop_s, 4))

    rows = []
    cols = {"ad_revenue": xs, "source_ip": fs}
    for name, (batched, serial_fn, members, col) in walks.items():
        v = ((fs, xs) if name == "groupby_pass1_batch"
             else P.distinct_form(cols[col]) if col == "source_ip"
             else cols[col])
        for S in (1, SHARDS):
            got = batched(v, S)
            want = serial_fn(v, S)
            ok = True
            for q, (dq, wq, _) in enumerate(members):
                if name == "groupby_pass1_batch":
                    ev, st = got
                    wev, wst = want[q]
                    ok &= all(same(a[q], b) for a, b in zip(ev, wev))
                    ok &= all(same(a[q, :, :dq, :wq].contiguous(), b)
                              for a, b in zip(st, wst))
                elif name == "topn_pass1_batch":
                    ok &= same(got[0][q], want[q][0])
                    ok &= same(got[1][q, :, :dq, :wq].contiguous(),
                               want[q][1])
                else:
                    k, sl, vl, hd = want[q]
                    ok &= same(got[0][q], k)
                    ok &= same(got[1][q, :, :dq, :wq].contiguous(), sl)
                    ok &= same(got[2][q, :, :dq, :wq].contiguous(), vl)
                    ok &= same(got[3][q, :, :dq].contiguous(), hd)
            check(ok, f"batch: {name} S={S} differs from {len(members)} "
                  "serial walks on the whole column")
        # the main path's shape: one lane, the whole column, the wave
        ms = event_ms(lambda: batched(v, 1), 5)
        serial_ms = event_ms(lambda: serial_fn(v, 1), 5)
        # plain version on the prefix (HostPlain, on the host)
        u = tuple(t[:BATCH_PREFIX] for t in v) if isinstance(v, tuple) \
            else v[:BATCH_PREFIX]
        plain, plain_s = host.get((name, 1, 1))
        d, w, sd, dc, wc = _walk_wave(members[:BATCH_PLAIN_Q])
        mine = (BW.groupby_pass1_batch(u[0], u[1], None, d=d, w=w, seeds=sd,
                                       agg="sum", shards=1, dcap=dc, wcap=wc)
                if name == "groupby_pass1_batch" else
                BW.topn_pass1_batch(u, d=d, w=w, seeds=sd, shards=1,
                                    dcap=dc, wcap=wc)
                if name == "topn_pass1_batch" else
                BW.distinct_pass1_batch(
                    u, d=d, w=w, seeds=sd, shards=1, dcap=dc, wcap=wc,
                    policy="lru" if name.endswith("_lru") else "fifo"))
        flat = (lambda x: [t for y in x for t in (y if isinstance(y, tuple)
                                                  else (y,))])
        pairs = list(zip(flat(mine), flat(plain)))
        err = max_abs_err(pairs)
        check(all(same(a, b) for a, b in pairs),
              f"batch: {name} differs from its plain version on the first "
              f"{BATCH_PREFIX} entries")
        # bytes: each input read once, each output written once
        m, Q = M_MAIN, len(members)
        d, w, sd, dc, wc = _walk_wave(members)
        if name == "topn_pass1_batch":
            nbytes = m * 4 + Q * m + Q * dc * wc * 4
        elif name == "groupby_pass1_batch":
            nbytes = 2 * m * 4 + Q * m * 9 + Q * dc * wc * 9
        else:
            nbytes = m * 4 + Q * m + Q * dc * (wc * 5 + 4)
        t_bytes = bytes_ms(nbytes)
        t_chain = batch_chain_ms(torch, name, v[0] if isinstance(v, tuple)
                                 else v, members, clock_hz)
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_chain
                     else (t_chain, "operations"))
        say("batch", kernel=name, queries=Q, ms=ms,
            serial_walks_ms=serial_ms, bytes_ms=t_bytes, chain_ms=t_chain,
            plain_prefix_s=round(plain_s, 3), plain_queries=BATCH_PLAIN_Q)
        rows.append(_row(name, counts, err, ms, plain_s * 1e3, bound, by))
    return rows


# --------------------------------------------------------------- phase tune
TUNE_SCALE = 3_000_000          # lineitem rows of the TPC-H subset suite
                                # (~SF 0.5: Q1's f32 flag sums stay < 2^24)
TUNE_PATH_KERNELS = ("topn_pass1", "topn_apply", "topn_det_pass1",
                     "distinct_pass1", "distinct_pass1_lru",
                     "distinct_apply", "skyline_pass1", "skyline_apply",
                     "cms_build", "cms_query", "groupby_pass1")


def answer_err(torch, a, b) -> float:
    """How far two run_query answers are apart (the keep masks of two plans
    may differ: a tuned plan is two_pass, tune="off" a scan): 0.0 when
    equal, inf when they differ, and for GROUP BY's {key: sum} of the same
    keys the largest relative difference (f32 partials split by another
    plan round otherwise)."""
    x, y = a["output"], b["output"]
    if isinstance(x, torch.Tensor):
        return 0.0 if same(x, y) else float("inf")
    if isinstance(x, tuple):
        return 0.0 if all(same(p, q) for p, q in zip(x, y)) \
            else float("inf")
    if isinstance(x, dict) and x.keys() == y.keys():
        return max((abs(x[k] - y[k]) / max(abs(y[k]), 1e-300)
                    for k in y), default=0.0)
    return 0.0 if x == y else float("inf")


def tune_engine_calls(torch, table, fresh):
    """Part 1 of phase tune: each engine call of phase planner through the
    tuner on the whole 2^25-entry stream."""
    from repro_torch import core

    for name, algo, cols, params in ENGINE_CALLS:
        streams = engine_streams(torch, table, algo, cols)
        inc = core.analytic_plan(algo, streams, params)
        plans = core.candidate_plans(algo, streams, params, incumbent=inc)
        base = core.execute_plan(algo, *streams, plan=inc, obs="off",
                                 **params).keep
        for plan in plans[1:]:
            keep = core.execute_plan(algo, *streams, plan=plan, obs="off",
                                     **params).keep
            check(same(keep, base), f"tune: {name} candidate {plan.key()} "
                  f"keep differs from the incumbent {inc.key()}")
        cache = fresh(name)
        res = core.tune(algo, streams, params, cache=cache)
        full = {}
        for label, plan in (("incumbent", inc), ("winner", res.plan)):
            full[label] = min(sync_time(lambda: core.execute_plan(
                algo, *streams, plan=plan, obs="off", **params))[1]
                for _ in range(2))
        again = core.resolve_plan(algo, streams, params, tune_mode="cached",
                                  cache=cache)
        check(again.source == "cache" and again.plan == res.plan,
              f"tune: {name} cached replay {again.source} "
              f"{again.plan.key()} is not the race's {res.plan.key()}")
        fresh_cache = fresh(name + " engine")
        ep = core.engine_prune(algo, *streams, tune="race",
                               plan_cache=fresh_cache, obs="off", **params)
        ep_plan = core.resolve_plan(algo, streams, params,
                                    tune_mode="cached",
                                    cache=fresh_cache).plan
        check(same(ep.keep, core.execute_plan(
            algo, *streams, plan=ep_plan, obs="off", **params).keep),
            f"tune: {name} engine_prune(tune='race') keep differs from "
            f"execute_plan({ep_plan.key()})")
        say("tune", call=json.dumps(name), incumbent=inc.key(),
            candidates=len(plans), winner=res.plan.key(),
            probe_us=json.dumps({k: round(v, 1)
                                 for k, v in res.timings.items()}),
            speedup_x=round(res.speedup_x, 4),
            race_wall_s=round(res.race_wall_s, 4),
            incumbent_s=round(full["incumbent"], 5),
            winner_s=round(full["winner"], 5),
            kept=int(base.sum()))
    fs = table.cols["source_ip"]
    codes, enc = table.encode("source_ip").col("source_ip").code_stream()
    a = core.engine_prune("distinct", codes, encoding=enc, tune="race",
                          plan_cache=fresh("dict codes"), obs="off",
                          **DISTINCT)
    b = core.engine_prune("distinct", fs, tune="race",
                          plan_cache=fresh("dict decoded"), obs="off",
                          **DISTINCT)
    check(same(a.keep, b.keep), "tune: dict-encoded DISTINCT tune='race' "
          "keep differs from the decoded call's")


def tune_batch_groups(torch, table, fresh):
    """Part 2 of phase tune: phase batch's DISTINCT LRU x3 and GROUP BY
    SUM x3 groups through run_queries at tune off, race and cached, and
    each query's execute_plan_batch keep against its execute_plan."""
    from repro_torch import core
    from repro_torch.query import QuerySpec, run_queries

    specs = batch_specs(QuerySpec)
    specs = [s for s in specs if (s.kind, s.params.get("policy")) ==
             ("distinct", "lru") or s.kind == "groupby"]
    cache = fresh("batch")
    off, off_s = sync_time(lambda: run_queries(specs, table))
    race, race_s = sync_time(lambda: run_queries(specs, table, tune="race",
                                                 plan_cache=cache))
    cached, cached_s = sync_time(lambda: run_queries(
        specs, table, tune="cached", plan_cache=cache))
    rel = 0.0
    for spec, a, b, c in zip(specs, off, race, cached):
        err = max(answer_err(torch, b, a), answer_err(torch, c, a))
        # DISTINCT's answer is exact; GROUP BY SUM of the f32 ad_revenue
        # within phase main's 1e-2 relative
        check(err <= (1e-2 if spec.kind == "groupby" else 0.0),
              f"tune: run_queries {spec.kind} {spec.params} tuned answer "
              f"differs from tune='off' ({err} relative)")
        rel = max(rel, err)
    fs, xs = table.cols["source_ip"], table.cols["ad_revenue"]
    plans = {}
    for algo, streams, queries in (
            ("distinct", (fs,), [dict(d=d, w=w, policy="lru", seed=sd)
                                 for d, w, sd in BATCH_DISTINCT]),
            ("groupby", (fs, xs), [dict(d=d, w=w, agg="sum", seed=sd)
                                   for d, w, sd in BATCH_GROUPBY])):
        plan = core.resolve_plan(algo, streams, queries[0],
                                 tune_mode="cached", cache=cache)
        check(plan.source == "cache", f"tune: run_queries' {algo} group "
              "left no plan in its cache")
        plans[algo] = plan.plan.key()
        rb = core.execute_plan_batch(algo, queries, *streams, plan=plan.plan)
        for i, q in enumerate(queries):
            one = core.execute_plan(algo, *streams, plan=plan.plan,
                                    obs="off", **q)
            check(same(rb.keep[i], one.keep), f"tune: execute_plan_batch "
                  f"{algo} query {q} keep differs from its execute_plan")
    say("tune", path="run_queries", queries=len(specs),
        plans=json.dumps(plans), groupby_max_rel_vs_off=rel,
        off_s=round(off_s, 4),
        race_s=round(race_s, 4), cached_s=round(cached_s, 4))


def tune_suite(torch, fresh):
    """Part 3 of phase tune: the TPC-H subset suite on the card, each query
    at tune off, race and cached against its plain-Python reference."""
    from repro_torch.query import workloads

    tabs, gen_s = sync_time(lambda: workloads.tpch_tables(TUNE_SCALE,
                                                          seed=0))
    say("tune", suite_rows=TUNE_SCALE, generate_s=round(gen_s, 3))
    for q in workloads.SUITE:
        t0 = time.perf_counter()
        want = q.reference(tabs)
        ref_s = time.perf_counter() - t0
        cache = fresh(q.name)
        secs = {}
        for tune in ("off", "race", "cached"):
            got, secs[tune] = sync_time(lambda: q.run(
                tabs, tune=tune, plan_cache=cache))
            check(got == want, f"tune: suite {q.name} at tune={tune} "
                  "differs from its plain-Python reference")
        say("tune", suite=q.name, algo=q.algo, off_s=round(secs["off"], 4),
            race_s=round(secs["race"], 4), cached_s=round(secs["cached"], 4),
            reference_s=round(ref_s, 3))


def phase_tune(torch, P, table):
    """Self-tuned plans on the card: every race gets a PlanCache in a fresh
    temporary directory (a plan left by an earlier run would skip it).
    Every launch count is zeroed before the phase's paths and read after:
    each kernel of the tuned engine calls, and the Bloom pair of suite Q3,
    must have run."""
    import shutil
    import tempfile

    from repro_torch.core import PlanCache

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_plans_"))

    def fresh(name):
        return PlanCache(tmp / re.sub(r"\W+", "_", name) / "plans.json")

    try:
        P.reset_launch_counts()
        tune_engine_calls(torch, table, fresh)
        tune_batch_groups(torch, table, fresh)
        tune_suite(torch, fresh)
        counts = {k.name: k.launches for k in P.KERNELS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in TUNE_PATH_KERNELS + ("bloom_query",):
        check(counts[k] > 0, f"tune: kernel {k} was never launched")
    check(counts["bloom_build"] + counts["bloom_build_global"] > 0,
          "tune: suite Q3 built no Bloom filter on the card")
    say("tune", launches=json.dumps({k: v for k, v in counts.items() if v},
                                    separators=(",", ":")))


# -------------------------------------------------------------- phase edges
EDGE_DOCS = 1 << 20             # documents of one worker's corpus shard
EDGE_PIPE = dict(vocab=32000, seq_len=128, batch_size=64, seed=0)
EDGE_DUP = 0.3
EDGE_QUALITY = 0.25
EDGE_BLOCK = 16                 # the pipeline's dedup block
EDGE_DEDUP = ((1024, 4), (32768, 4))   # the pipeline's default cache, and
                                # one that holds a real share of a shard
EDGE_FP_LOOP_DOCS = 4096        # documents held to the per-document loop
# The plain LRU scan walks one entry at a time on the host (about 0.1 ms an
# entry), so the LRU run's keep is held to it on this prefix of the column:
# a one-lane scan's keep of a prefix is the prefix of its keep.
EDGE_LRU_PLAIN = 1 << 18
EDGE_PROMPTS = 1 << 16          # the serving queue: prompts drawn zipf(1.2)
EDGE_PROMPT_POOL = 1 << 14      # from this many strings of 16-200 bytes
EDGE_CALL = 256                 # prompts a RequestCache.dedup call
EDGE_CACHE = dict(d=256, w=4)
# The protocol's stream: the simulation costs O(m^2 p) Python steps, since
# a round walks every unacknowledged packet and drops all after its first
# gap (the reference's cost too), so it takes the first 4096 entries.
EDGE_PROTOCOL_M = 4096
EDGE_PROTOCOL_Q = ((4096, 4, 0), (2048, 2, 3), (1024, 3, 5))  # LRU d, w, seed
EDGE_DROPS = (0.0, 0.02)
EDGE_LOGITS = (64, 151936)      # a decode batch over Qwen3's vocabulary
EDGE_LOGIT_SHARDS = 16
EDGE_KS = (1, 8)
EDGE_PATH_KERNELS = ("distinct_pass1_block_walk", "distinct_pass1_lru",
                     "distinct_apply", "distinct_pass1_batch_lru")


def np_mix32(x, seed: int = 0):
    """The murmur3 fmix32 finalizer in numpy uint32 (wrapping) arithmetic."""
    import numpy as np

    h = x.astype(np.uint32) ^ np.uint32(seed)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def np_doc_fps(flat, starts, lens):
    """The reference's document fingerprint over a whole corpus in numpy:
    the first 64 token hashes of each folded as out * 31 + v (mod 2^32)."""
    import numpy as np

    j = np.arange(64)
    valid = j < lens[:, None]
    h = np_mix32(flat[np.where(valid, starts[:, None] + j, 0)]).astype(
        np.uint64)
    out = np.zeros(lens.size, np.uint64)
    for t in range(64):
        out = np.where(valid[:, t], (out * 31 + h[:, t]) & 0xFFFFFFFF, out)
    return out.astype(np.uint32)


def np_doc_fp_loop(doc) -> int:
    """One document's fingerprint by the reference's own loop: every token
    hashed, the first 64 hashes folded."""
    out = 0
    for v in np_mix32(doc).ravel()[:64].tolist():
        out = (out * 31 + v) & 0xFFFFFFFF
    return out


def edge_prompts():
    """The serving queue: EDGE_PROMPTS prompts, zipf(1.2) over
    EDGE_PROMPT_POOL printable strings of 16-200 bytes, seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    pool = ["".join(map(chr, rng.integers(32, 127, int(n))))
            for n in rng.integers(16, 201, EDGE_PROMPT_POOL)]
    ranks = (rng.zipf(1.2, EDGE_PROMPTS) - 1) % EDGE_PROMPT_POOL
    return [pool[r] for r in ranks]


def _edges_host_job(kind, arg, d, w):
    """A plain run of phase edges in a worker process, on one thread:
    ("dedup", uint32 fingerprints viewed as int32) the block walk's plain
    version at B = EDGE_BLOCK, keep and state; ("lru", the same) the LRU
    scan's keep on the CPU over the first EDGE_LRU_PLAIN entries;
    ("requests", prompts) the RequestCache's calls on the CPU, its live
    masks, then one call after a reset. Returns (numpy results, seconds)."""
    import torch

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if kind == "dedup":
        from repro_torch.kernels import ref as R

        keep, (sl, va, he) = R.distinct_block_ref(
            torch.from_numpy(arg).view(torch.uint32), d=d, w=w,
            block=EDGE_BLOCK, return_state=True)
        out = (keep.numpy(), sl.view(torch.int32).numpy(), va.numpy(),
               he.numpy())
    elif kind == "lru":
        from repro_torch import core

        fps = torch.from_numpy(arg[:EDGE_LRU_PLAIN]).view(torch.uint32)
        out = core.distinct_prune(fps, d=d, w=w).keep.numpy()
    else:
        from repro_torch.serve import RequestCache

        rc = RequestCache(d=d, w=w, device="cpu")
        calls = [rc.dedup(arg[i:i + EDGE_CALL])
                 for i in range(0, len(arg), EDGE_CALL)]
        masks = torch.cat(rc._stream.live_masks()).numpy()
        rc.reset()
        out = (calls, masks, rc.dedup(arg[:EDGE_CALL]))
    return out, time.perf_counter() - t0


def edges_pipeline(docs, dev):
    """The pipeline's runs on the main path: batches() at both caches of
    EDGE_DEDUP with the block kernel, and once with the LRU scan; each
    run's wall time ends in a synchronise."""
    from repro_torch.data import TokenPipeline

    runs = {}
    for d, w in EDGE_DEDUP:
        pipe = TokenPipeline(**EDGE_PIPE, dedup_d=d, dedup_w=w,
                             dedup_block=EDGE_BLOCK,
                             quality_min=EDGE_QUALITY, device=dev)
        runs[d] = (pipe,) + sync_time(lambda: list(pipe.batches(docs)))
    pipe = TokenPipeline(**EDGE_PIPE, use_kernel=False,
                         quality_min=EDGE_QUALITY, device=dev)
    runs["lru"] = (pipe,) + sync_time(lambda: list(pipe.batches(docs)))
    return runs


def edges_requests(prompts, dev):
    """The RequestCache's calls on the card: (fresh lists and fingerprints
    of each call, the live masks, the call after a reset, seconds of each
    call)."""
    import torch

    from repro_torch.serve import RequestCache

    rc = RequestCache(**EDGE_CACHE, device=dev)
    calls, secs = [], []
    for i in range(0, len(prompts), EDGE_CALL):
        out, s = sync_time(lambda: rc.dedup(prompts[i:i + EDGE_CALL]))
        calls.append(out)
        secs.append(s)
    masks = torch.cat(rc._stream.live_masks()).cpu().numpy()
    rc.reset()
    return calls, masks, rc.dedup(prompts[:EDGE_CALL]), secs


def edges_protocol(v):
    """The §7.2 protocol over the Q = 3 DISTINCT queries' batched keep masks
    of ``v``: (keep [Q, m], {drop: (result, seconds)})."""
    from repro_torch import core
    from repro_torch.query import simulate_lossy_stream_multi

    queries = [dict(d=d, w=w, policy="lru", seed=s)
               for d, w, s in EDGE_PROTOCOL_Q]
    keep = core.engine_prune_batch("distinct", queries, v).keep
    sims = {}
    for drop in EDGE_DROPS:
        t0 = time.perf_counter()
        sims[drop] = (simulate_lossy_stream_multi(v, keep, drop, seed=0,
                                                  max_rounds=5000),
                      time.perf_counter() - t0)
    return keep, sims


def edges_check_lru(pipe, keep, job):
    """The LRU run's keep on the card against the plain LRU scan on the
    CPU, on the first EDGE_LRU_PLAIN entries."""
    import numpy as np

    plain, secs = job.get()
    n = plain.size
    check(np.array_equal(keep[:n], plain),
          f"edges: the LRU scan at d={pipe.dedup_d}, w={pipe.dedup_w} differs "
          f"from core.distinct_prune on the CPU over the first {n} entries")
    say("edges", kernel="distinct_pass1_lru", d=pipe.dedup_d, w=pipe.dedup_w,
        m_plain=n, kept_plain=int(plain.sum()), plain_s=round(secs, 3))


def edges_check_pipeline(torch, runs, docs, flat_np, fps, quality, plain):
    """Every run's stages and batches against numpy: the dedup keep (the
    plain block walk's; the LRU run's from the card, held to the plain scan
    on its prefix by edges_check_lru) keeps every distinct fingerprint once at
    least, the stats count what the masks say,
    and the batches are the survivors' tokens concatenated, cut into rows
    of seq_len + 1 and batches of batch_size, the partial ones dropped."""
    import numpy as np

    row, bs = EDGE_PIPE["seq_len"] + 1, EDGE_PIPE["batch_size"]
    lens = np.fromiter((d.size for d, _ in docs), np.int64, len(docs))
    starts = np.cumsum(lens) - lens
    fps_np = fps.view(torch.int32).cpu().numpy().view(np.uint32)
    fkeep = quality > np.float32(EDGE_QUALITY)
    for key, (pipe, batches, secs) in runs.items():
        keep = plain[key]
        check(np.array_equal(np.unique(fps_np[keep]), np.unique(fps_np)),
              f"edges: pipeline {key} dropped a fingerprint altogether")
        surv = keep & fkeep
        st = pipe.stats
        check((st.seen_docs, st.deduped_docs, st.filtered_docs,
               st.emitted_batches) ==
              (len(docs), int((~keep).sum()), int((keep & ~fkeep).sum()),
               len(batches)), f"edges: pipeline {key} stats {st}")
        total = int(lens[surv].sum())
        check(len(batches) == total // row // bs,
              f"edges: pipeline {key} gave {len(batches)} batches, not "
              f"({total} // {row}) // {bs}")
        need = len(batches) * bs * row
        k = int(((np.cumsum(lens[surv]) - lens[surv]) < need).sum())
        want = np.concatenate([flat_np[starts[i]:starts[i] + lens[i]]
                               for i in np.nonzero(surv)[0][:k]])[:need]
        got = torch.stack([torch.cat([b["tokens"], b["labels"][:, -1:]], 1)
                           for b in batches])
        check(got.dtype == torch.int32
              and np.array_equal(got.cpu().numpy().reshape(-1), want),
              f"edges: pipeline {key} batches differ from the numpy packing")
        say("edges", pipeline=key, batches=len(batches),
            kept_docs=int(surv.sum()), deduped=st.deduped_docs,
            filtered=st.filtered_docs, batches_s=round(secs, 4),
            docs_per_s=round(len(docs) / secs, 1),
            corpus_tokens_per_s=round(int(lens.sum()) / secs, 1),
            emitted_tokens=need)


def edges_block_walk(torch, P, fps, jobs, runs, counts, clock_hz):
    """ops.distinct_prune's kernel at the pipeline's B = 16, at both caches,
    on the whole 2^20-entry fingerprint column: keep and state bit for bit
    against the plain block walk, its time and its bound. Returns the plain
    keeps and the kernels line's row (d = 1024)."""
    m = fps.numel()
    keeps, rows = {}, []
    for d, w in EDGE_DEDUP:
        (keep, *st), secs = jobs[d].get()
        plain = (torch.from_numpy(keep), torch.from_numpy(st[0]).view(
            torch.uint32)) + tuple(torch.from_numpy(a) for a in st[1:])
        keeps[d] = keep
        out = P.distinct_shard_states_kernel(fps, d=d, w=w, shards=1,
                                             block=EDGE_BLOCK)
        out = (out[0],) + tuple(t[0] for t in out[1:])
        err = max_abs_err([(a.cpu(), b) for a, b in zip(out, plain)])
        check(err == 0.0 and all(same(a.cpu(), b)
                                 for a, b in zip(out, plain)),
              f"edges: the block walk at B={EDGE_BLOCK}, d={d} differs "
              "from its plain version")
        check(same(runs[d][0].dedup_keep(fps).cpu(), plain[0]),
              f"edges: ops.distinct_prune at d={d} differs from the plain "
              "block walk")
        ms = event_ms(lambda: P.distinct_shard_states_kernel(
            fps, d=d, w=w, shards=1, block=EDGE_BLOCK), 5)
        io_ms = bytes_ms(m * 4 + m + d * w * 5 + d * 4)
        bound, by = block_walk_bound(torch, fps, out[0], 1, EDGE_BLOCK, d,
                                     io_ms, clock_hz)
        say("edges", kernel="distinct_pass1_block_walk", B=EDGE_BLOCK, d=d,
            w=w, m=m, kept=int(keep.sum()), ms=ms, plain_s=round(secs, 3),
            bound_ms=bound, bound_by=by)
        if d == EDGE_DEDUP[0][0]:
            name = "distinct_pass1_block_walk_b16"
            rows.append(_row(name, {name: counts["distinct_pass1_block_walk"]},
                             err, ms, secs * 1e3, bound, by))
    return keeps, rows


def edges_check_requests(calls, masks, after_reset, call_s, job):
    """The RequestCache on the card against the same calls on the CPU: the
    fresh lists, fingerprints and live masks equal, every fingerprint's
    first occurrence kept, and a reset that makes the first call fresh
    again."""
    import numpy as np

    (cpu_calls, cpu_masks, cpu_reset), cpu_s = job.get()
    check(calls == cpu_calls and np.array_equal(masks, cpu_masks),
          "edges: RequestCache on the card differs from the CPU's")
    fp_all = np.array([f for _, fp in calls for f in fp], np.int64)
    _, first = np.unique(fp_all, return_index=True)
    check(bool(masks[first].all()),
          "edges: RequestCache pruned a fingerprint's first occurrence")
    check(after_reset == cpu_reset == calls[0],
          "edges: RequestCache.reset() did not drop the switch state")
    us = sorted(s * 1e6 for s in call_s)
    say("edges", requests=len(fp_all), calls=len(calls),
        distinct_fps=first.size, fresh=int(masks.sum()),
        call_us_median=us[len(us) // 2], call_us_max=us[-1],
        cpu_run_s=round(cpu_s, 3))


def edges_check_protocol(torch, v, pkeep, sims):
    """The card's batched keep masks bit for bit against the same
    engine_prune_batch call on a CPU copy (the plain batched walk);
    delivered_all, the master's rows a superset of every query's keep,
    and each query's DISTINCT completion over the rows the master received,
    and over its own keep, equal to the true distinct set."""
    import numpy as np

    from repro_torch import core

    queries = [dict(d=d, w=w, policy="lru", seed=s)
               for d, w, s in EDGE_PROTOCOL_Q]
    cpu_keep = core.engine_prune_batch("distinct", queries, v.cpu()).keep
    check(same(pkeep.cpu(), cpu_keep),
          "edges: engine_prune_batch's DISTINCT masks on the card differ "
          "from the same call on the CPU")
    vals = v.cpu().numpy()
    truth = set(vals.tolist())
    union = pkeep.any(0).cpu().numpy()
    for q in range(pkeep.shape[0]):
        own = core.master_complete_distinct(v, pkeep[q]).cpu().numpy()
        check(set(vals[own].tolist()) == truth,
              f"edges: query {q}'s DISTINCT completion is wrong")
    for drop, (sim, secs) in sims.items():
        got = np.zeros(vals.size, bool)
        got[sim["master_indices"]] = True
        out = core.master_complete_distinct(
            v, torch.from_numpy(got).to(v.device)).cpu().numpy()
        check(sim["delivered_all"] and not (union & ~got).any()
              and set(vals[out].tolist()) == truth,
              f"edges: the protocol at drop {drop} lost a survivor or a "
              "distinct value")
        say("edges", protocol_drop=drop, m=vals.size,
            queries=pkeep.shape[0], forwarded=int(union.sum()),
            received=len(sim["master_indices"]), rounds=sim["rounds"],
            s=round(secs, 4))


def edges_steps(torch, docs, runs, quality, dev):
    """The ms of each of batches()' steps on the card, on the uploaded
    corpus: the upload (host concatenation and copy, wall), the
    fingerprints, the dedup at each cache and with the LRU scan, the
    filter and the packing. Returns the fingerprints."""
    from repro_torch.data import TokenPipeline

    (flat, starts, lens), up_s = sync_time(
        lambda: TokenPipeline.upload(docs, dev))
    fps = TokenPipeline.doc_fingerprints(flat, starts, lens)
    pipe = runs[EDGE_DEDUP[0][0]][0]
    qt = torch.from_numpy(quality).to(dev)
    ms = dict(upload=up_s * 1e3, fingerprint=event_ms(
        lambda: TokenPipeline.doc_fingerprints(flat, starts, lens), 3))
    for key, (p, _, _) in runs.items():
        ms[f"dedup_{key}"] = event_ms(lambda: p.dedup_keep(fps), 3)
    ms["filter"] = event_ms(lambda: pipe.quality_keep(qt), 3)
    surv = pipe.dedup_keep(fps) & pipe.quality_keep(qt)
    ms["pack"] = event_ms(lambda: pipe.pack(flat, starts, lens, surv), 3)
    say("edges", step_ms=json.dumps({k: round(x, 4) for k, x in ms.items()}))
    return fps, pipe.quality_keep(qt).cpu().numpy()


def phase_edges(torch, P, table, clock_hz):
    """The edges of the system on the card (ROADMAP Queue 1 item 13): the
    token pipeline on a 2^20-document corpus shard, the RequestCache on a
    2^16-prompt queue, the §7.2 protocol over batched DISTINCT masks and
    pruned_topk over a [64, 151936] decode batch. The launch counts are
    zeroed before these paths and read after. The plain block walks at
    B = 16 and the RequestCache's CPU run start first, in worker processes,
    and are compared last. Returns the kernels line's row of the block walk
    at the pipeline's B = 16."""
    import multiprocessing

    import numpy as np

    from repro_torch.data import TokenPipeline
    from repro_torch.serve import pruned_topk

    dev = table.cols["source_ip"].device
    docs, corpus_s = sync_time(
        lambda: TokenPipeline(**EDGE_PIPE).corpus(EDGE_DOCS, EDGE_DUP))
    lens = np.fromiter((d.size for d, _ in docs), np.int64, len(docs))
    flat_np = np.concatenate([d for d, _ in docs])
    fps_np, np_fp_s = sync_time(lambda: np_doc_fps(
        flat_np, np.cumsum(lens) - lens, lens))
    quality = np.asarray([q for _, q in docs], np.float64).astype(np.float32)
    prompts = edge_prompts()
    say("edges", docs=len(docs), unique_fps=len(np.unique(fps_np)),
        tokens=int(lens.sum()), corpus_host_s=round(corpus_s, 3),
        numpy_fp_s=round(np_fp_s, 3), prompts=len(prompts))
    pool = multiprocessing.get_context("spawn").Pool(len(EDGE_DEDUP) + 2)
    try:
        jobs = {d: pool.apply_async(_edges_host_job, (
            "dedup", fps_np.view(np.int32), d, w)) for d, w in EDGE_DEDUP}
        jobs["lru"] = pool.apply_async(_edges_host_job, (
            "lru", fps_np.view(np.int32), TokenPipeline.dedup_d,
            TokenPipeline.dedup_w))
        jobs["requests"] = pool.apply_async(_edges_host_job, (
            "requests", prompts, EDGE_CACHE["d"], EDGE_CACHE["w"]))

        # ---- the main path, its launches counted
        v = table.cols["source_ip"][:EDGE_PROTOCOL_M]
        g = torch.Generator(device=dev).manual_seed(0)
        logits = torch.randn(EDGE_LOGITS, generator=g, device=dev)
        P.reset_launch_counts()
        runs = edges_pipeline(docs, dev)
        calls, masks, after_reset, call_s = edges_requests(prompts, dev)
        pkeep, sims = edges_protocol(v)
        tops = {k: pruned_topk(logits, k, EDGE_LOGIT_SHARDS)
                for k in EDGE_KS}
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in P.KERNELS}
        for k in EDGE_PATH_KERNELS:
            check(counts[k] > 0, f"edges: kernel {k} was never launched")
        say("edges", launches=json.dumps({k: c for k, c in counts.items()
                                          if c}, separators=(",", ":")))

        # ---- the fingerprints and the filter against numpy
        fps, fkeep = edges_steps(torch, docs, runs, quality, dev)
        got_fp = fps.view(torch.int32).cpu().numpy().view(np.uint32)
        check(np.array_equal(got_fp, fps_np),
              "edges: the pipeline's fingerprints differ from numpy's fold")
        loop = [np_doc_fp_loop(d) for d, _ in docs[:EDGE_FP_LOOP_DOCS]]
        check(got_fp[:EDGE_FP_LOOP_DOCS].tolist() == loop,
              "edges: the pipeline's fingerprints differ from the "
              "reference's per-document loop")
        check(np.array_equal(fkeep, quality > np.float32(EDGE_QUALITY)),
              "edges: the quality filter differs from numpy's")
        edges_check_protocol(torch, v, pkeep, sims)
        for k, (fv, fi) in tops.items():
            tv, ti = torch.topk(logits, k)
            check(same(fv, tv) and same(fi, ti)
                  and same(logits.gather(1, fi), fv),
                  f"edges: pruned_topk k={k} differs from torch.topk")
            say("edges", pruned_topk_k=k, shape=list(EDGE_LOGITS),
                shards=EDGE_LOGIT_SHARDS,
                ms=event_ms(lambda: pruned_topk(logits, k,
                                                EDGE_LOGIT_SHARDS), 20),
                full_topk_ms=event_ms(lambda: torch.topk(logits, k), 20))

        # ---- the plain runs, last
        keeps, rows = edges_block_walk(torch, P, fps, jobs, runs, counts,
                                       clock_hz)
        lru = runs["lru"][0]
        keeps["lru"] = lru.dedup_keep(fps).cpu().numpy()
        edges_check_pipeline(torch, runs, docs, flat_np, fps, quality,
                             keeps)
        edges_check_requests(calls, masks, after_reset, call_s,
                             jobs["requests"])
        edges_check_lru(lru, keeps["lru"], jobs["lru"])
    finally:
        pool.terminate()
        pool.join()
    return rows


# -------------------------------------------------------------- phase serve
SERVE_ARCH = "qwen3-1.7b"       # served at full width (configs.get)
SERVE_REQUESTS = 8              # 4 distinct prompts, each sent twice
SERVE_DISTINCT = 4
SERVE_PROMPT = 8
SERVE_NEW = 16
SERVE_TRACK = 16                # track_topn
SERVE_SHARDS = 16               # the vocab shards of the logit wire
SERVE_TOPK = 8                  # candidates a shard ships a step
SERVE_TOL = 0.08                # of the largest |logit|: the reference's own
                                # decode-vs-forward tolerance for bf16 paths
# card against CPU at smoke size: SERVE_TOL, except for the three archs
# whose logits move by more than it when one parameter moves by one bf16
# ulp (the random init's weights of std (layers)^-0.5 saturate their
# softmaxes and routers); phase serve prints that shift for every arch
# (``sensitivity``): 0.095 moonshot, 0.29 jamba, 0.27 seamless on the CPU
SERVE_CARD_TOL = {"moonshot-v1-16b-a3b": 0.3, "jamba-1.5-large-398b": 0.3,
                  "seamless-m4t-large-v2": 0.3}
SERVE_SMOKE = dict(B=2, S=16, steps=4)   # the ten archs, card against CPU
SERVE_TIMING_PAIRS = 3          # generate with and without tracking, in turns
SERVE_PATH_KERNELS = ("distinct_pass1_lru", "distinct_apply",
                      "topn_det_pass1")


def rel_to_max(torch, want, got) -> float:
    want, got = want.double().cpu(), got.double().cpu()
    return float((want - got).abs().max() / want.abs().max())


def smoke_batch(torch, cfg, B, S, dev):
    import numpy as np

    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.normal(0, 0.02, (B, cfg.frontend_len,
                                                 cfg.d_model))
    if cfg.frontend == "audio":
        b["frame_embeds"] = rng.normal(0, 0.02, (B, S, cfg.d_model))
    return {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
            .to(dev) if v.dtype == np.float64 else torch.from_numpy(v).to(dev)
            for k, v in b.items()}


def serve_logits(torch, lm, b, steps):
    """The forward logits and ``steps`` decode steps' logits of ``lm`` on
    batch ``b``."""
    B = b["tokens"].shape[0]
    hidden, _ = lm.forward(b)
    cache = lm.init_cache(B, steps)
    if lm.cfg.n_enc_layers:
        cache["cross"] = lm.build_cross_cache(lm.encode(b["frame_embeds"]))
    return [lm.logits(hidden)] + [lm.decode_step(cache, b["tokens"][:, i],
                                                 i)[0] for i in range(steps)]


def serve_card_vs_cpu(torch, configs, LM):
    """Each of the ten archs at smoke size: the card's forward logits and a
    decode of SERVE_SMOKE["steps"] tokens against the port's CPU run of the
    same parameters; beside it, the shift of the CPU's logits when the first
    layer's ln1 gamma[0] moves by one bf16 ulp (the model's own noise)."""
    import copy

    B, S, steps = SERVE_SMOKE["B"], SERVE_SMOKE["S"], SERVE_SMOKE["steps"]
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_smoke(arch)
        cpu = LM(cfg)
        cpu.init(0, device="cpu")
        card = copy.deepcopy(cpu).to("cuda")
        want = serve_logits(torch, cpu, smoke_batch(torch, cfg, B, S, "cpu"),
                            steps)
        got = serve_logits(torch, card,
                           smoke_batch(torch, cfg, B, S, "cuda"), steps)
        gamma = cpu.params()["groups"]["blk0"]["ln1"]
        g0 = gamma[0, 0].clone()
        gamma[0, 0] = (g0.view(torch.int16) + 1).view(torch.bfloat16)
        bumped = serve_logits(torch, cpu,
                              smoke_batch(torch, cfg, B, S, "cpu"), steps)
        gamma[0, 0] = g0
        errs = [rel_to_max(torch, a, g) for a, g in zip(want, got)]
        noise = max(rel_to_max(torch, a, g) for a, g in zip(want, bumped))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        tol = SERVE_CARD_TOL.get(arch, SERVE_TOL)
        check(finite and max(errs) < tol,
              f"serve: {arch} on the card differs from the CPU: forward "
              f"{errs[0]:.3g}, decode {max(errs[1:]):.3g} (tol {tol})")
        say("serve", smoke=arch, forward_err=f"{errs[0]:.3e}",
            decode_err=f"{max(errs[1:]):.3e}", tol=tol,
            sensitivity=f"{noise:.3e}")


def serve_profile(torch, fn):
    """(the card's busy ms over fn() by torch.profiler, or None when the
    profiler saw no device time; the five costliest device ops' ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the kernels' own rows (a CPU op's row repeats its kernels' time)
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages() if e.self_device_time_total > 0
           and str(e.device_type).endswith("CUDA")]
    ops.sort(key=lambda o: -o[1])
    busy = sum(o[1] for o in ops)
    return (busy or None), [[k[:60], round(ms, 3), n] for k, ms, n in ops[:5]]


def phase_serve(torch, P, card):
    """The LM serving path (ROADMAP Queue 1 items 15a, 15d): qwen3-1.7b at
    full width from the port's init on the card; 8 requests (4 distinct)
    through a RequestCache, then ServeEngine.generate of 16 tokens with
    track_topn=16. The launch counts are zeroed before the dedup and read
    after generate. Then decode against forward at full width, determinism,
    passive tracking, the trace against torch.topk of the folded wire, the
    ladder kernel against its plain version on that wire, the decode step's
    time, and the ten smoke archs on the card against the CPU."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels.topn_det_scan import (init_state,
                                                   topn_det_pass1_kernel,
                                                   topn_det_pass1_plain)
    from repro_torch.models import LM
    from repro_torch.serve import RequestCache, ServeEngine

    class Recording(ServeEngine):
        def _step(self, cache, tok, pos):
            tok, cand, cache = super()._step(cache, tok, pos)
            self.cands.append(cand)
            return tok, cand, cache

    dev = torch.device("cuda")
    cfg = configs.get(SERVE_ARCH)
    lm = LM(cfg)
    torch.cuda.reset_peak_memory_stats()
    _, init_s = sync_time(lambda: lm.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = sum(p.numel() for p in lm.parameters())
    say("serve", arch=SERVE_ARCH, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab_padded=cfg.vocab_padded, params=n_params,
        param_count=cfg.param_count(),
        param_gb=round(sum(p.numel() * p.element_size()
                           for p in lm.parameters()) / 1e9, 3),
        init_s=round(init_s, 3))
    eng = Recording(lm, n_logit_shards=SERVE_SHARDS, topk=SERVE_TOPK,
                    device=dev)
    rc = RequestCache(device=dev)
    requests = [f"request-{i % SERVE_DISTINCT}"
                for i in range(SERVE_REQUESTS)]
    rng = np.random.default_rng(0)

    # ---- the main path, its launches counted
    eng.cands = []
    P.reset_launch_counts()
    t0 = time.perf_counter()
    fresh, _ = rc.dedup(requests)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (len(fresh), SERVE_PROMPT)).astype(np.int32)).to(dev)
    tokens, trace = eng.generate(prompts, SERVE_NEW, track_topn=SERVE_TRACK)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {k.name: k.launches for k in P.KERNELS}
    say("serve", launches=json.dumps({k: c for k, c in counts.items() if c},
                                     separators=(",", ":")),
        requests=len(requests), fresh=len(fresh), first_call_s=round(
            first_s, 3), peak_gb=round(torch.cuda.max_memory_allocated()
                                       / 1e9, 3))
    check(len(fresh) == SERVE_DISTINCT,
          f"serve: {len(fresh)} fresh requests of {SERVE_REQUESTS}, want "
          f"{SERVE_DISTINCT}")
    for k in SERVE_PATH_KERNELS:
        check(counts[k] > 0, f"serve: kernel {k} was never launched")
    check(counts["topn_det_pass1"] == SERVE_NEW,
          f"serve: topn_det_pass1 launched {counts['topn_det_pass1']} times "
          f"for {SERVE_NEW} folds")
    check(tokens.shape == (SERVE_DISTINCT, SERVE_NEW)
          and tokens.dtype == np.int32 and (tokens >= 0).all()
          and (tokens < cfg.vocab_padded).all(),
          f"serve: tokens {tokens.shape} {tokens.dtype} out of range")

    # ---- the trace, and the ladder kernel against its plain version
    wire = torch.cat(eng.cands)
    want = torch.topk(wire, SERVE_TRACK).values.cpu()
    check(same(torch.from_numpy(trace.values), want),
          "serve: the trace differs from torch.topk of the folded wire")
    check(trace.entries == wire.numel() and 0 < trace.shipped
          <= trace.entries, f"serve: trace entries {trace.entries}, "
          f"shipped {trace.shipped}, wire {wire.numel()}")
    st_k = init_state(1, 8, dev)
    st_p = init_state(1, 8, "cpu")
    keeps = []
    for c in eng.cands:
        kk, st_k = topn_det_pass1_kernel(c, N=SERVE_TRACK, w=8, state=st_k)
        kp, st_p = topn_det_pass1_plain(c.cpu().reshape(1, -1),
                                        N=SERVE_TRACK, w=8, state=st_p)
        keeps.append((kk.cpu(), kp.reshape(-1)))
    pairs = keeps + list(zip((s.cpu() for s in st_k), st_p))
    err = max_abs_err(pairs)
    check(all(same(a, b) for a, b in pairs),
          "serve: topn_det_pass1 differs from its plain version on the "
          "candidate wire")
    c = eng.cands[-1]
    fold_ms = event_ms(lambda: topn_det_pass1_kernel(
        c, N=SERVE_TRACK, w=8, state=st_k), 20)
    _, fold_plain_s = sync_time(lambda: topn_det_pass1_plain(
        c.cpu().reshape(1, -1), N=SERVE_TRACK, w=8, state=st_p))
    say("serve", trace_entries=trace.entries, shipped=trace.shipped,
        wire_saving=round(1 - trace.shipped / trace.entries, 6),
        ladder_max_abs_err=err, top=f"{float(trace.values[0]):.6g}",
        ladder_fold_ms=round(fold_ms, 4),
        ladder_fold_plain_ms=round(fold_plain_s * 1e3, 4),
        ladder_fold_bound_ms=bytes_ms(c.numel() * 5 + 4 * (3 + 8) * 2))

    # ---- determinism, passive tracking, times (in turns; medians)
    times = {False: [], True: []}
    for i in range(2 * SERVE_TIMING_PAIRS):
        tracked = i % 4 in (1, 2)
        out, secs = sync_time(lambda: eng.generate(
            prompts, SERVE_NEW, track_topn=SERVE_TRACK if tracked else None))
        times[tracked].append(secs)
        toks = out[0] if tracked else out
        check(np.array_equal(toks, tokens) and (not tracked or same(
            torch.from_numpy(out[1].values), want)),
            "serve: generate is not deterministic, or tracking is not "
            "passive")
    plain_s, again_s = (sorted(times[k])[len(times[k]) // 2]
                        for k in (False, True))
    B = len(fresh)
    cache = lm.init_cache(B, SERVE_PROMPT + SERVE_NEW)
    _, prefill_s = sync_time(lambda: lm.prefill_via_decode(cache, prompts))
    tok = prompts[:, -1]

    def steps():
        for t in range(SERVE_NEW):
            lm.decode_step(cache, tok, SERVE_PROMPT + t)

    _, decode_s = sync_time(steps)
    step_ms = decode_s / SERVE_NEW * 1e3
    device_ms, top = serve_profile(torch, steps)
    say("serve", card=json.dumps(card), batch=B, prompt=SERVE_PROMPT,
        new=SERVE_NEW, generate_s=round(plain_s, 4),
        generate_tracked_s=round(again_s, 4),
        tracking_share=round(1 - plain_s / again_s, 4),
        generate_s_all=json.dumps([round(t, 4) for t in times[False]]),
        tracked_s_all=json.dumps([round(t, 4) for t in times[True]]),
        prefill_s=round(prefill_s, 4), decode_step_ms=round(step_ms, 3),
        decode_tok_s=round(B / (step_ms / 1e3), 1),
        generate_tok_s=round(B * SERVE_NEW / plain_s, 1),
        device_ms_per_step=("not measured" if device_ms is None
                            else round(device_ms / SERVE_NEW, 4)),
        idle_share=("not measured" if device_ms is None
                    else round(1 - device_ms / (decode_s * 1e3), 4)))
    say("serve", device_ms_by_kernel=json.dumps(top))

    # ---- decode against forward at full width
    hidden, _ = lm.forward({"tokens": prompts})
    full = lm.logits(hidden[:, -1:])[:, 0]
    cache = lm.init_cache(B, SERVE_PROMPT)
    last, _ = lm.prefill_via_decode(cache, prompts)
    err = rel_to_max(torch, full, last)
    check(bool(torch.isfinite(last).all()) and err < SERVE_TOL,
          f"serve: full-width decode differs from forward by {err:.4g} of "
          f"the largest logit (tol {SERVE_TOL})")
    say("serve", decode_vs_forward=f"{err:.4e}", tol=SERVE_TOL,
        max_logit=f"{float(full.abs().max()):.4g}")
    del lm, eng, cache, hidden
    torch.cuda.empty_cache()
    serve_card_vs_cpu(torch, configs, LM)


# ------------------------------------------------------------- phase stream
STREAM_BATCH = 1 << 20          # entries a micro-batch of phase stream
STREAM_RAGGED = 77              # batch 5 is this much short, batch 6 long
STREAM_CUTS = (0.31, 0.64)      # a lane's ragged pieces (of its length)
STREAM_PLAIN = 1 << 15          # lane 0 entries carried, then resumed, in
                                # the check against the plain versions
STREAM_KS = (1, 4, 16)          # merge periods (16 for the slope only)
# the kernels each engine call's stream must launch
STREAM_NEEDS = {
    "topn_rand": ("topn_pass1", "topn_apply"),
    "topn_det": ("topn_det_pass1",),
    "distinct fifo": ("distinct_pass1", "distinct_apply"),
    "distinct lru": ("distinct_pass1_lru", "distinct_apply"),
    "skyline": ("skyline_pass1", "skyline_apply"),
    "having count": ("cms_build", "cms_query"),
    "groupby count": ("groupby_pass1",),
}


def stream_sizes():
    """Micro-batches of STREAM_BATCH entries over the 2^25-row table, one
    of them short and the next long by STREAM_RAGGED (ragged against the
    128 lanes)."""
    sizes = [STREAM_BATCH] * (M_MAIN // STREAM_BATCH)
    sizes[5] -= STREAM_RAGGED
    sizes[6] += STREAM_RAGGED
    return sizes


def resumed_kernels(torch, table, pts):
    """The B = 1 pass-1 kernels that resume, each as (name, streams [m]
    or [m, D] tuple, run(streams, S, state, offset) -> (keep, state tuple,
    emitted tuple or None), fresh(S, device) -> an empty stacked state)."""
    from repro_torch.core import engine as E
    from repro_torch.kernels import groupby_scan as G
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import topn_det_scan as TD

    xs, fs = table.cols["ad_revenue"], table.cols["source_ip"]

    def state_of(algo, params):
        def fresh(S, dev):
            lane = E._SPECS[algo].init((torch.zeros(1, device=dev),), params)
            return tuple(t[None].expand((S,) + tuple(t.shape)).clone()
                         for t in vars(lane).values()
                         if isinstance(t, torch.Tensor))
        return fresh

    def topn(st, S, state, off):
        k, s = P.topn_shard_states_kernel(st[0], shards=S, block=1,
                                          family="engine", state=state[0],
                                          index_offset=off, **TOPN)
        return k, (s,), None

    def distinct(policy):
        def run(st, S, state, off):
            k, *s = P.distinct_shard_states_kernel(
                st[0], shards=S, block=1, policy=policy, state=state,
                **DISTINCT)
            return k, tuple(s), None
        return run

    def skyline(st, S, state, off):
        k, p, s = P.skyline_shard_states_kernel(st[0], shards=S, block=1,
                                                form="engine", state=state,
                                                **SKYLINE)
        return k, (p, s), None

    def groupby(st, S, state, off):
        ev, s = G.groupby_pass1_kernel(st[0], st[1], shards=S, agg="count",
                                       state=state, **GROUPBY)
        return None, tuple(s), tuple(ev)

    def ladder(st, S, state, off):
        k, s = TD.topn_det_pass1_kernel(st[0], shards=S, state=state,
                                        **TOPN_DET)
        return k, tuple(s), None

    def fresh_groupby(S, dev):
        return G.init_state(S, GROUPBY["d"], GROUPBY["w"], "count", dev)

    def fresh_ladder(S, dev):
        return TD.init_state(S, TOPN_DET["w"], dev)

    gvals = xs.float().contiguous()
    return (("topn_pass1", (xs,), topn, state_of("topn_rand", TOPN)),
            ("distinct_pass1 fifo", (fs,), distinct("fifo"),
             state_of("distinct", DISTINCT)),
            ("distinct_pass1 lru", (fs,), distinct("lru"),
             state_of("distinct", DISTINCT)),
            ("skyline_pass1", (pts,), skyline,
             lambda S, dev: tuple(t[None].expand((S,) + tuple(t.shape))
                                  .clone() for t in vars(E._SPECS[
                                      "skyline"].init((pts[:1],), SKYLINE))
                                  .values()
                                  if isinstance(t, torch.Tensor))),
            ("groupby_pass1", (fs, gvals), groupby, fresh_groupby),
            ("topn_det_pass1", (xs,), ladder, fresh_ladder))


def lane_pieces(torch, streams, S, cuts):
    """Each lane of ``streams`` cut at the same ragged points: per piece
    (its lane start, its streams [S * n] of that piece of every lane)."""
    L = streams[0].shape[0] // S
    bounds = [0] + [int(c * L) + 3 for c in cuts] + [L]
    out = []
    for a, b in zip(bounds, bounds[1:]):
        out.append((a, tuple(
            s.reshape((S, L) + tuple(s.shape[1:]))[:, a:b]
            .reshape((-1,) + tuple(s.shape[1:])).contiguous()
            for s in streams)))
    return out


def stream_resume(torch, table, pts):
    """Part (a) of phase stream: each resumed B = 1 pass-1 kernel, at
    S = 128 and 1 on the whole 2^25-row column cut into 3 ragged pieces a
    lane, each piece from the state the last one left (the first from an
    empty one), with the lane offset: keep (GROUP BY's emissions) and the
    final state bit for bit against the one-pass kernel (which phase
    kernels holds to its plain version), and the TOP-N apply with the
    offset against the whole apply; then each resumed kernel on lane 0's
    entries STREAM_PLAIN..2 STREAM_PLAIN from the state of its first
    STREAM_PLAIN (carried, not empty) against its plain version on CPU
    copies."""
    from repro_torch.kernels import parallel as P

    for name, streams, run, fresh in resumed_kernels(torch, table, pts):
        for S in (SHARDS, 1):
            L = M_MAIN // S
            (k1, st1, ev1), one_s = sync_time(
                lambda: run(streams, S, None if name != "topn_pass1"
                            else (None,), 0))
            state = fresh(S, streams[0].device)
            ptrs = [t.data_ptr() for t in state]
            keeps, evs, secs = [], [], 0.0
            for a, piece in lane_pieces(torch, streams, S, STREAM_CUTS):
                (k, state, ev), s = sync_time(
                    lambda: run(piece, S, state, a))
                secs += s
                n = piece[0].shape[0] // S
                if k is not None:
                    keeps.append(k.reshape(S, n))
                if ev is not None:
                    evs.append(tuple(e.reshape(S, n) for e in ev))
            ok = all(same_bits(a_, b_) for a_, b_ in zip(state, st1))
            ok &= [t.data_ptr() for t in state] == ptrs
            if keeps:
                ok &= same(torch.cat(keeps, 1), k1.reshape(S, L))
            if evs:
                ok &= all(same_bits(torch.cat([e[i] for e in evs], 1),
                                    ev1[i].reshape(S, L)) for i in range(3))
            check(ok, f"stream: resumed {name} S={S} differs from the "
                  "one-pass kernel")
            say("stream", resume=json.dumps(name), S=S, pieces=3,
                one_pass_s=round(one_s, 4), resumed_s=round(secs, 4), ok=ok)
            if name == "topn_pass1":
                merged = P.merge_topn_states(st1[0], TOPN["w"])
                whole = P.topn_apply_kernel(streams[0], merged, shards=S,
                                            d=TOPN["d"], family="engine")
                parts = [P.topn_apply_kernel(
                    piece[0], merged, shards=S, d=TOPN["d"], family="engine",
                    index_offset=a).reshape(S, -1)
                    for a, piece in lane_pieces(torch, streams, S,
                                                STREAM_CUTS)]
                check(same(torch.cat(parts, 1), whole.reshape(S, L)),
                      f"stream: topn_apply with offsets S={S} differs")
        # lane 0's first 2 STREAM_PLAIN entries: the second half resumed
        # from the first half's state, on the card and in the plain version
        head = tuple(s[:STREAM_PLAIN] for s in streams)
        tail = tuple(s[STREAM_PLAIN:2 * STREAM_PLAIN].contiguous()
                     for s in streams)
        _, carried, _ = run(head, 1, fresh(1, streams[0].device), 0)
        got = run(tail, 1, tuple(t.clone() for t in carried), STREAM_PLAIN)
        want, plain_s = on_host(
            lambda *a: run(a[:len(tail)], 1, tuple(a[len(tail):]),
                           STREAM_PLAIN), *tail, *carried)
        ok = all(same_bits(a_, b_) for a_, b_ in
                 zip(_flat(got), _flat(want)))
        check(ok, f"stream: resumed {name} differs from its plain version "
              "on a carried state")
        say("stream", resume_plain=json.dumps(name), entries=STREAM_PLAIN,
            carried_entries=STREAM_PLAIN, plain_s=round(plain_s, 3), ok=ok)


def _flat(out):
    keep, state, ev = out
    return ((() if keep is None else (keep,)) + tuple(state)
            + (() if ev is None else tuple(ev)))


def stream_vs_one_shot(torch, P, table):
    """Parts (b) to (d) of phase stream, for each engine call of section 5
    at S = 128 over micro-batches of STREAM_BATCH (stream_sizes): close()
    bit for bit against one-shot engine_prune(mode="two_pass") on the
    lane-view stream at merge_every 1 and 4 (GROUP BY's emissions too);
    live keeps what close keeps where a stale snapshot only loosens
    (TOP-N det, HAVING, whose live mask is all True, GROUP BY), and the
    count that close keeps but live drops elsewhere (an evicting cache can
    give an entry back at close); the kernels the stream launched (counts
    set to 0 before the first stream); each fold's host us and device ms,
    the merge and the close, the stream's entries/s against the one-shot
    two_pass, window_blocks, and whether the lane states kept their
    data_ptr; and the live-kept fraction at merge_every 1, 4 and 16, whose
    slope against the mean lag (K - 1) / 2 is the staleness rate sigma."""
    from repro_torch import core

    sizes = stream_sizes()
    sigmas = {}
    for name, algo, cols, params in ENGINE_CALLS:
        streams = engine_streams(torch, table, algo, cols)
        one, one_s = sync_time(lambda: core.engine_prune(
            algo, *streams, mode="two_pass", shards=SHARDS, obs="off",
            **params))
        _, one_s2 = sync_time(lambda: core.engine_prune(
            algo, *streams, mode="two_pass", shards=SHARDS, obs="off",
            **params))
        lv, valid, arrival = core.lane_view(algo, streams, sizes, SHARDS,
                                            **params)
        lone = core.engine_prune(algo, *lv, mode="two_pass", shards=SHARDS,
                                 obs="off", **params)
        fracs = {}
        for K in STREAM_KS:
            P.reset_launch_counts()
            s = core.PruneStream(algo, shards=SHARDS, merge_every=K,
                                 obs="off", **params)
            host_us, dev_ms, ptrs = [], [], None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lo = 0
            for b in sizes:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                h0 = time.perf_counter()
                s.fold(*(x[lo:lo + b] for x in streams))
                host_us.append((time.perf_counter() - h0) * 1e6)
                e1.record()
                dev_ms.append((e0, e1))
                lo += b
                if ptrs is None:
                    ptrs = [t.data_ptr() for t in vars(s.lane_state)
                            .values() if isinstance(t, torch.Tensor)]
            res, close_s = sync_time(s.close)
            wall = time.perf_counter() - t0
            counts = {k.name: k.launches for k in P.KERNELS}
            dev = sorted(a.elapsed_time(b) for a, b in dev_ms)
            stable = ptrs == [t.data_ptr() for t in vars(s.lane_state)
                              .values() if isinstance(t, torch.Tensor)]
            merge_ms = event_ms(lambda: s._merge_now(), 3)
            live, keep = res.live_keep, res.keep
            fracs[K] = float(live.float().mean())
            ok = stable
            if K == 1:
                for k in STREAM_NEEDS[name]:
                    ok &= check(counts[k] > 0, f"stream: {name} never "
                                f"launched {k}")
            if K in (1, 4):
                ok &= check(same(keep[arrival[valid]], lone.keep[valid]),
                            f"stream: {name} K={K} close() differs from "
                            "one-shot two_pass on the lane view")
                if res.emitted is not None:
                    ok &= check(stream_emitted_ok(torch, res, lone, sizes),
                                f"stream: {name} K={K} emissions differ "
                                "from the one-shot's")
                if algo in ("topn_det", "having", "groupby"):
                    ok &= check(bool(live[keep].all()), f"stream: {name} "
                                f"K={K} live drops what close keeps")
                if algo == "having":
                    ok &= check(bool(live.all()), "stream: HAVING's live "
                                "mask is not all True")
            say("stream", call=json.dumps(name), merge_every=K,
                batches=res.stats["batches"], merges=res.stats["merges"],
                window_blocks=res.stats["window_blocks"],
                fold_host_us_median=round(sorted(host_us)[len(host_us) // 2],
                                          1),
                fold_host_us_max=round(max(host_us), 1),
                fold_device_ms_median=round(dev[len(dev) // 2], 4),
                fold_device_ms_max=round(dev[-1], 4),
                merge_ms=round(merge_ms, 4), close_ms=round(close_s * 1e3, 3),
                stream_s=round(wall, 4),
                stream_entries_per_s=round(M_MAIN / wall),
                one_shot_s=round(min(one_s, one_s2), 4),
                one_shot_entries_per_s=round(M_MAIN / min(one_s, one_s2)),
                live_fraction=fracs[K],
                final_fraction=float(keep.float().mean()),
                close_not_live=int((keep & ~live).sum()),
                data_ptr_stable=stable, ok=ok,
                launches=json.dumps({k: n for k, n in counts.items() if n},
                                    separators=(",", ":")))
        lag = [(K - 1) / 2 for K in STREAM_KS]
        mx, my = sum(lag) / len(lag), sum(fracs.values()) / len(fracs)
        sigma = (sum((x - mx) * (fracs[K] - my) for x, K in
                     zip(lag, STREAM_KS))
                 / sum((x - mx) ** 2 for x in lag))
        sigmas[name] = sigma
        say("stream", call=json.dumps(name), sigma=sigma,
            live_fractions=json.dumps(fracs), one_shot_kept=float(
                one.keep.float().mean()))
    say("stream", sigma_by_call=json.dumps(sigmas))


def stream_emitted_ok(torch, res, lone, sizes) -> bool:
    """GROUP BY's emissions of the stream (batch after batch, each [S, nb]
    lane-major) against the one-shot's on the lane view (lane after lane):
    batch t's lane j is lane j's entries from its offset on."""
    L = lone.emitted[0].shape[0] // SHARDS
    ok, lo, off = True, 0, 0
    for b in sizes:
        nb = -(-b // SHARDS)
        for se, oe in zip(res.emitted, lone.emitted):
            ok &= same_bits(se[lo:lo + SHARDS * nb].reshape(SHARDS, nb),
                            oe.reshape(SHARDS, L)[:, off:off + nb])
        lo += SHARDS * nb
        off += nb
    return ok


def stream_merge_f32(torch):
    """The f32 HAVING merge in XLA's order (A29; off the main path, whose
    tables are integers): its time on 128 lane tables of 3 x 4096 beside
    torch's sum over the lanes."""
    from repro_torch.kernels.common import xla_sum_f32

    g = torch.Generator(device="cuda").manual_seed(29)
    t = torch.randn((SHARDS, 3, 4096), device="cuda", generator=g)
    say("stream", merge_f32_lanes=SHARDS, table="3x4096",
        xla_order_ms=round(event_ms(lambda: xla_sum_f32(t), 5), 4),
        torch_sum_ms=round(event_ms(lambda: t.sum(0), 5), 4))


def phase_stream(torch, P, table, pts):
    """Streaming and scan resume (ROADMAP Queue 1 item 9)."""
    stream_resume(torch, table, pts)
    stream_vs_one_shot(torch, P, table)
    stream_merge_f32(torch)


# ------------------------------------------------------------------ phase 4
# lane counts at which time_block_forms times both B > 1 forms
BLOCK_FORM_LANES = (1, 8, 16, 32, 64, SHARDS)
# (path, S, B) of every pass-1 launch on the main path. The first is the
# shape the kernels line reports; the S = 1, B = 1 scan is compared on a
# prefix (see phase_timing).
PASS1_SHAPES = (("ops.*_prune_parallel", SHARDS, 256),
                ("engine_prune two_pass", SHARDS, 1),
                ("ops.topn_prune / ops.distinct_prune", 1, 256),
                ("run_query / engine_prune scan", 1, 1))


def bytes_ms(nbytes):
    """ms to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def pass1_bound(m, S, B, in_bytes, state_bytes, clock_hz):
    """(ms, what sets it) of the least time of one launch of a block kernel
    (B > 1: TOP-N and DISTINCT).

    Bytes: read x once, write keep and the S final states. Chain: each lane
    makes m / (S * B) dependent steps on its shared-memory state, each of
    two round trips and two block barriers, counted at their floors.
    """
    t_bytes = (in_bytes + m + state_bytes) / HBM_BYTES_PER_S * 1e3
    cycles = 2 * (SMEM_CYCLES + BARRIER_CYCLES)
    t_chain = m // (S * B) * cycles / clock_hz * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_chain else (t_chain, "chain")


def time_block_forms(torch, P, fs, xs):
    """Both forms of pass 1 at B = 256 on the whole column, at S in
    BLOCK_FORM_LANES, of DISTINCT on source_ip and of TOP-N on ad_revenue:
    the block walk and the staged one-CTA-a-lane block kernel (its C entry,
    distinct_pass1 or topn_pass1 at block 256), the times behind
    kernels.parallel.use_block_walk, and the form it dispatches to. At
    S = 1 each form is timed on 3 runs."""
    for S in BLOCK_FORM_LANES:
        reps = 3 if S == 1 else 5
        dispatched = ("block walk" if P.use_block_walk(S, torch.device("cuda"))
                      else "block kernel")
        for name, walk, kernel in (
                ("distinct_pass1", lambda: P.distinct_block_walk_kernel(
                    fs, shards=S, block=256, **DISTINCT),
                 lambda: distinct_block_kernel(
                     torch, fs, S, DISTINCT["d"], DISTINCT["w"], 256, 0)),
                ("topn_pass1", lambda: P.topn_block_walk_kernel(
                    xs, shards=S, block=256, **TOPN),
                 lambda: topn_block_kernel(torch, xs, S, TOPN["d"],
                                           TOPN["w"], 256, 0))):
            ms_walk = event_ms(walk, reps)
            ms_block = event_ms(kernel, reps)
            faster = "block walk" if ms_walk < ms_block else "block kernel"
            say("timing", kernel=f"{name} B=256 forms", S=S,
                block_walk_ms=ms_walk, block_kernel_ms=ms_block,
                faster=json.dumps(faster), dispatched=json.dumps(dispatched))


def running_inserts(torch, v, w):
    """bool [G, L]: whether entry j of sequence g enters a store that keeps
    the sequence's w best values so far, i.e. beats the w-th best before
    it (a NaN, or a value <= NEG, never does): the inserts of a TOP-N row,
    or of a SKYLINE store at B = 1 on its scores. Chunks of growing size;
    in a chunk only the entries above the pre-chunk w-th best can insert,
    and those are taken in order."""
    from repro_torch.constants import NEG

    G, L = v.shape
    dev = v.device
    top = torch.full((G, w), float(NEG), device=dev)
    flags = torch.zeros((G, L), dtype=torch.bool, device=dev)
    rows = torch.arange(G, device=dev)
    c0, K = 0, 64
    while c0 < L:
        blk = v[:, c0:c0 + K]
        k = blk.shape[1]
        cand = blk > top[:, -1:]
        kmax = int(cand.sum(1).max())
        pos = torch.where(cand, torch.arange(k, device=dev), k).sort(1) \
            .values[:, :kmax]
        for j in range(kmax):
            p = pos[:, j]
            x = blk.gather(1, p.clamp(max=k - 1)[:, None])[:, 0]
            ins = (p < k) & (x > top[:, -1])
            flags[rows[ins], c0 + p[ins]] = True
            new = torch.sort(torch.cat([top, x[:, None]], 1), 1,
                             descending=True).values[:, :w]
            top = torch.where(ins[:, None], new, top)
        c0 += k
        K = min(2 * K, 1 << 16)
    return flags


def prefix_bound(torch, name, v, S, B, io_ms, clock_hz):
    """(ms, what sets it) of the least time of the TOP-N walks (B = 1, and
    the block walk) or the SKYLINE prefix merge on this stream: the larger
    of ``io_ms`` and the work's own chain, the most inserts one store
    takes, counted here without the kernel (running_inserts). TOP-N: the
    inserts of the costliest (lane, row) segment, REG_STEP_CYCLES each (the
    walk keeps the row in registers); at B > 1 the inserting (row, block)
    groups, whose candidates form the row's sequence. SKYLINE: the inserts
    of the lane with the most, and at B > 1 its blocks whose best
    candidate enters the store (those after the first w of each block's
    top-w do not count), SMEM_CYCLES + BARRIER_CYCLES each (the store is
    in shared memory, a step ends in a barrier). Every other entry only
    reads the store it finds."""
    from repro_torch.constants import NEG
    from repro_torch.core.hashing import hash_mod
    from repro_torch.core.skyline import score as skyline_score

    m = v.shape[0]
    n = m // S
    dev = v.device
    if name == "topn_pass1":
        # a segment's (row, block) groups in stream order, each its
        # candidate (the group's max; a NaN propagates and never inserts):
        # at B = 1 a group is one entry
        d, w = TOPN["d"], TOPN["w"]
        idx = torch.arange(n, device=dev).repeat(S)
        seg = (torch.arange(S, device=dev).repeat_interleave(n) * d
               + hash_mod(idx, d, 0))
        grp, inv = torch.unique(seg * (n // B) + idx // B,
                                return_inverse=True)
        cand = torch.full((grp.numel(),), float(NEG), device=dev) \
            .scatter_reduce(0, inv, v, "amax")
        ss = grp // (n // B)
        counts = torch.bincount(ss, minlength=S * d)
        starts = torch.cumsum(counts, 0) - counts
        mat = torch.full((S * d, int(counts.max())), float("nan"),
                         device=dev)
        mat[ss, torch.arange(grp.numel(), device=dev) - starts[ss]] = cand
        inserts = int(running_inserts(torch, mat, w).sum(1).max())
        cycles = REG_STEP_CYCLES
    else:
        w = SKYLINE["w"]
        h = skyline_score(v.view(S, n, -1), SKYLINE["score"],
                          "kernel" if B > 1 else "engine")
        if B > 1:
            top = torch.where(h.isnan(), -float("inf"), h).view(
                S, n // B, B).topk(min(w, B), dim=-1).values
            fl = running_inserts(torch, top.reshape(S, -1), w).view(
                S, n // B, -1)[..., 0]
        else:
            fl = running_inserts(torch, h, w)
        inserts = int(fl.sum(1).max())
        cycles = SMEM_CYCLES + BARRIER_CYCLES
    t_chain = inserts * cycles / clock_hz * 1e3
    say("timing", kernel=name, S=S, B=B, store_inserts_max=inserts,
        chain_ms=t_chain)
    return (io_ms, "bytes") if io_ms >= t_chain else (t_chain, "chain")


def pass1_fns(algo, P, R):
    """(kernel, plain) of one algorithm: (values, S, B) -> (keep, states).

    SKYLINE's main path takes the Pallas kernels' APH association in the
    ``ops`` calls (B = 256) and the engine's in the engine (B = 1)."""
    if algo == "skyline_pass1":
        def kernel(v, S, B):
            keep, pts, scs = P.skyline_shard_states_kernel(
                v, shards=S, block=B, form="kernel" if B > 1 else "engine",
                **SKYLINE)
            return keep, (pts, scs)

        def plain(v, S, B):
            keep, st = R.skyline_block_ref(
                v.reshape(S, -1, v.shape[1]), block=B,
                form="kernel" if B > 1 else "engine", return_state=True,
                **SKYLINE)
            return keep.reshape(-1), st
        return kernel, plain
    if algo == "topn_pass1":
        # the family each main-path caller takes: ops.topn_prune (S = 1,
        # B > 1) the kernels' (the one-hot read, A27), the engine (B = 1) and
        # ops.topn_prune_parallel (which drops pass 1's keep) the engine's
        def family(S, B):
            return "kernel" if S == 1 and B > 1 else "engine"

        def kernel(v, S, B):
            keep, st = P.topn_shard_states_kernel(v, shards=S, block=B,
                                                  family=family(S, B),
                                                  **TOPN)
            return keep, (st,)

        def plain(v, S, B):
            keep, st = R.topn_block_ref(v.reshape(S, -1), block=B,
                                        return_state=True,
                                        onehot=family(S, B) == "kernel",
                                        **TOPN)
            return keep.reshape(-1), (st,)
        return kernel, plain

    def kernel(v, S, B):
        keep, *st = P.distinct_shard_states_kernel(v, shards=S, block=B,
                                                   **DISTINCT)
        return keep, tuple(st)

    def plain(v, S, B):
        keep, st = R.distinct_block_ref(v.reshape(S, -1), block=B,
                                        return_state=True, **DISTINCT)
        return keep.reshape(-1), st
    return kernel, plain


def phase_timing(torch, P, R, table, rankings, pts, totals, clock_hz,
                 encoded, rle, host):
    """Each kernel against its plain version at every main-path shape on the
    2^25-row table, its median time, and its bound. The plain pass-1 loops
    that run on the host come from ``host`` (HostPlain), started before
    phase kernels, on columns checked here to be the main path's; their
    comparisons are made last, so that a loop still running does not hold
    up the phase's other work."""
    xs = table.cols["ad_revenue"]
    fs = table.cols["source_ip"]
    m = M_MAIN
    rows, states, pending = [], {}, []
    for name, v in (("topn_pass1", xs), ("distinct_pass1", fs),
                    ("skyline_pass1", pts)):
        check(same(host.cols[name].cuda(), v),
              f"{name}: the host loops' column is the main path's")
    for name, v, state_bytes in [
            ("topn_pass1", xs, lambda S: S * TOPN["d"] * TOPN["w"] * 4),
            ("distinct_pass1", fs,
             lambda S: S * (DISTINCT["d"] * DISTINCT["w"] * 5
                            + DISTINCT["d"] * 4)),
            ("skyline_pass1", pts,
             lambda S: S * SKYLINE["w"] * (pts.shape[1] + 1) * 4)]:
        kernel, plain = pass1_fns(name, P, R)
        for path, S, B in PASS1_SHAPES:
            keep, st = kernel(v, S, B)
            # The kernels line has a row for each kernel: TOP-N's and
            # DISTINCT's at B > 1 are the block kernel and the block walk,
            # as use_block_walk dispatches, each reported at its first
            # shape. The first shape's plain version runs on the card; the
            # others run on the host (HostPlain), the block walks' (S = 1,
            # B = 256) too: on the card their 131,072 block steps take
            # minutes.
            row = name
            if name != "skyline_pass1" and B > 1:
                row += ("_block_walk" if P.use_block_walk(S, v.device)
                        else "_block")
            walk = row.endswith("_block_walk")
            host_side = path != PASS1_SHAPES[0][0]
            if host_side and S == 1 and B == 1:
                # The keep of entry i of a one-lane scan depends only on
                # entries 0..i, so the plain scan of a prefix checks the
                # full-size run's keep there, and the kernel rerun on the
                # prefix its state. The plain loop takes one Python step
                # an entry.
                n = SCAN_PREFIX
                keep_p, st_p = kernel(v[:n], S, B)
                pairs = [(keep[:n], None), (keep_p, None),
                         *((a, i) for i, a in enumerate(st_p))]
            elif host_side:
                n = m
                pairs = [(keep, None), *((a, i) for i, a in enumerate(st))]
            else:
                n = m
                (keep2, st2), plain_s = sync_time(lambda: plain(v, S, B))
                pairs = [(keep, keep2), *zip(st, st2)]
            if B == 1 and S > 1:
                states[name] = (keep, st)
            if B == 256 and S > 1:
                states[name + " ops"] = (keep, st)
            # the full-size run above was the warm-up
            ms = event_ms(lambda: kernel(v, S, B), 5, warm=False)
            device_ms = queued_ms(lambda: kernel(v, S, B), 10)
            in_bytes = v.numel() * v.element_size()
            io_ms = bytes_ms(in_bytes + m + state_bytes(S))
            if name == "distinct_pass1" and B == 1:
                bound, by = walk_bound(torch, v, S, DISTINCT["d"], None,
                                       io_ms, clock_hz)
            elif walk and name == "distinct_pass1":
                bound, by = block_walk_bound(torch, v, keep, S, B,
                                             DISTINCT["d"], io_ms, clock_hz)
            elif name == "skyline_pass1" or B == 1 or walk:
                bound, by = prefix_bound(torch, name, v, S, B, io_ms,
                                         clock_hz)
            else:
                bound, by = pass1_bound(m, S, B, in_bytes, state_bytes(S),
                                        clock_hz)
            steps = m // (S * B)
            line = dict(kernel=row, path=json.dumps(path), S=S, B=B, ms=ms,
                        device_ms=device_ms, compared_entries=n,
                        bound_ms=bound, bound_by=by,
                        chain_steps=steps, step_us=ms * 1e3 / steps,
                        kept=int(keep.sum()))
            pending.append((name, row, S, B, pairs, line,
                            None if host_side else plain_s))

    # pass 2 on the merged states of both two-pass callers: S = 128 after
    # B = 256 (ops.*_prune_parallel, the timed shape) and after B = 1
    # (engine_prune two_pass)
    d_t, d_d = TOPN["d"], DISTINCT["d"]
    rows.append(time_topn_apply(torch, P, xs, states, totals))

    errs = []
    for key in ("distinct_pass1 ops", "distinct_pass1"):
        kd, (sl, va, _) = states[key]
        mslots, mvalid = P.merge_distinct_states(sl, va)
        kda = P.distinct_apply_kernel(fs, kd, mslots, mvalid, d=d_d,
                                      shards=SHARDS)
        kda2, plain_s = sync_time(lambda: P.distinct_apply_plain(
            fs, kd, mslots, mvalid, d=d_d, shards=SHARDS))
        errs.append(max_abs_err([(kda, kda2)]))
        check(errs[-1] == 0.0, f"distinct_apply after {key} at 2^25 rows")
        if key.endswith("ops"):
            ms = event_ms(lambda: P.distinct_apply_kernel(
                fs, kd, mslots, mvalid, d=d_d, shards=SHARDS), 10)
            plain_ms = plain_s * 1e3
            # bytes this run's data needs: keep1 read and keep written in
            # full, the fingerprints of pass-1 survivors only (whole 32-byte
            # sectors that hold one), and the union read once
            sectors = int(kd.view(-1, 8).any(1).sum())
            nbytes = m + m + sectors * 32 + mslots.numel() * 5
            say("timing", profile="distinct_apply", S=SHARDS,
                survivors=int(kd.sum()), device_ms=device_split(
                    torch, lambda: P.distinct_apply_kernel(
                        fs, kd, mslots, mvalid, d=d_d, shards=SHARDS)))
    rows.append(_row("distinct_apply", totals, max(errs), ms, plain_ms,
                     nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    rows.append(time_skyline_apply(torch, P, pts, states, totals))
    rows.extend(time_cms(torch, table, totals, clock_hz))
    rows.extend(time_bloom(torch, table, rankings, totals, clock_hz))
    time_bloom_sweep(torch, table)
    rows.append(time_groupby(torch, table, totals, clock_hz))
    profile_walks(torch, table, pts)
    time_ascending(torch, P)
    time_block_forms(torch, P, fs, xs)
    rows.append(time_topn_det(torch, xs, totals))
    lru = time_lru(torch, P, R, fs, totals, clock_hz, host)
    rle_row = time_rle(torch, *rle, totals)
    time_decode(torch, encoded)
    rows.append(time_topn_fixup(torch, P, R, xs, totals))
    a27_host_check(torch, P, host)
    return pass1_rows(pending, totals, host) + rows + [lru, rle_row]


def time_topn_fixup(torch, P, R, xs, totals):
    """The kernels' family's fix-up (topn_onehot_fixup) on the main path's
    column at S = 1, B = 256 (ops.topn_prune), where no row minimum is +inf
    and it reads each lane's d minima and returns: against ref.onehot_keep
    on the same direct keep, matrices and tinf; bound by the bytes of the
    minima it must read."""
    direct, st, tinf = topn_pass1_tinf(torch, P, xs, 1, 256)
    fixed = direct.clone()
    P.topn_onehot_fixup(fixed, st, tinf, shards=1, d=TOPN["d"], block=256)
    want, plain_s = sync_time(lambda: R.onehot_keep(
        direct.view(1, -1), st, tinf.view(1, -1).to(torch.int64),
        d=TOPN["d"], block=256).reshape(-1))
    err = max_abs_err([(fixed, want)])
    check(err == 0.0, "topn_onehot_fixup on the main path's column")
    ms = event_ms(lambda: P.topn_onehot_fixup(fixed, st, tinf, shards=1,
                                              d=TOPN["d"], block=256), 20)
    dev = queued_ms(lambda: P.topn_onehot_fixup(fixed, st, tinf, shards=1,
                                                d=TOPN["d"], block=256), 50)
    say("timing", kernel="topn_onehot_fixup", S=1, B=256, ms=ms,
        queued_ms=dev, plain_ms=plain_s * 1e3)
    return _row("topn_onehot_fixup", totals, err, ms, plain_s * 1e3,
                bytes_ms(TOPN["d"] * 4), "bytes")


def pass1_rows(pending, totals, host):
    """The pass-1 comparisons of phase timing, made once their plain
    versions have run: bit-identical keep and state, each shape's line, and
    a kernels-line row a kernel, at its first shape."""
    errs, firsts = {}, {}
    for name, row, S, B, pairs, line, plain_s in pending:
        plain_on = "card" if plain_s is not None else "host"
        if plain_s is None:
            (keep2, st2), plain_s = host.get((name, S, B))
            got = (keep2, *st2)
            pairs = [(a, got[0] if i is None else got[i + 1])
                     for a, i in pairs]
        err = max_abs_err(pairs)
        errs.setdefault(row, []).append(err)
        check(err == 0.0, f"{name} S={S} B={B} on the 2^25-row table")
        say("timing", **line, plain_ms=plain_s * 1e3, plain_on=plain_on,
            max_abs_err=err)
        firsts.setdefault(row, (line["ms"], plain_s * 1e3, line["bound_ms"],
                                line["bound_by"]))
    return [_row(row, totals, max(errs[row]), *first)
            for row, first in firsts.items()]


def time_topn_apply(torch, P, xs, states, totals):
    """topn_apply on the merged states of both two-pass callers, in the
    family each takes: ops.topn_prune_parallel (S = 128 after B = 256, the
    kernels' family) and engine_prune two_pass (after B = 1, the engine's),
    each against its plain version on the card, with its call time (event
    medians of whole calls), its device time (calls queued back to back),
    the plain version's time, and a yardstick: one torch.ge of x viewed as
    [S, L] against a precomputed [L] vector of the entries' row minima, a
    PyTorch call over the same bytes (not the same function: the rows and
    their reads are computed beforehand). The shifted body (shards off 16
    bytes) is timed and checked at the same aligned shape (apply_shifted),
    and the apply it replaced (the C entry topn_apply_grid) beside it,
    after B = 1."""
    from repro_torch.core.hashing import hash_mod
    from repro_torch.kernels.common import (I32, I64, P as VP, U32,
                                            grid_for, ptr)

    d, m = TOPN["d"], M_MAIN
    errs, out = [], {}
    for key, fam in (("topn_pass1 ops", "kernel"), ("topn_pass1", "engine")):
        merged = P.merge_topn_states(states[key][1][0], TOPN["w"])
        call = (lambda: P.topn_apply_kernel(xs, merged, d=d, shards=SHARDS,
                                            family=fam))
        ka = call()
        ka2, plain_s = sync_time(lambda: P.topn_apply_plain(
            xs, merged[:, -1], d=d, shards=SHARDS, family=fam))
        errs.append(max_abs_err([(ka, ka2)]))
        check(errs[-1] == 0.0, f"topn_apply {fam} after {key} at 2^25 rows")
        rowmin = merged[:, -1].contiguous()
        reads = rowmin[hash_mod(torch.arange(m // SHARDS, device="cuda"), d,
                                0)]
        xv = xs.view(SHARDS, -1)
        shifted, ks = apply_shifted(torch, P, xs, merged, fam)
        shifted()
        check(same(ks, ka), f"topn_apply {fam}: the shifted body on aligned "
              "shards")
        out[fam] = dict(ms=event_ms(call, 20), device_ms=queued_ms(call, 50),
                        shifted_device_ms=queued_ms(shifted, 50),
                        plain_ms=event_ms(lambda: P.topn_apply_plain(
                            xs, merged[:, -1], d=d, shards=SHARDS,
                            family=fam), 5),
                        yardstick_ms=event_ms(lambda: torch.ge(xv, reads),
                                              20),
                        host_us=host_call_us(torch, call),
                        kept=int(ka.sum()))
        say("timing", kernel="topn_apply", family=fam, after=json.dumps(key),
            plan=json.dumps(P.apply_plan(xs.device, SHARDS, m // SHARDS, d,
                                         True)), **out[fam])
    old = torch.empty(m, dtype=torch.bool, device="cuda")

    def grid():
        serial_kernel(torch, "topn_apply_grid", [VP] * 3 + [I64, I32, I32,
                                                           U32, I32],
                      ptr(xs), ptr(rowmin), ptr(old), m, m // SHARDS, d, 0,
                      grid_for(m, xs.device))
    say("timing", kernel="topn_apply_grid", after=json.dumps("topn_pass1"),
        ms=event_ms(grid, 20), device_ms=queued_ms(grid, 50))
    # bytes: read x, write keep, read the d row minima
    bound = (m * 4 + m + d * 4) / HBM_BYTES_PER_S * 1e3
    k = out["kernel"]
    return _row("topn_apply", totals, max(errs), k["ms"], k["plain_ms"],
                bound, "bytes")


def apply_shifted(torch, P, xs, merged, fam):
    """(a launch of topn_apply's shifted body, the body for shards off 16
    bytes, at the main path's aligned shape; its keep mask): the C entry
    called with aligned = 0, which the wrapper never passes there. Phase
    timing times it beside the aligned body that the main path runs."""
    from repro_torch.kernels.common import ptr

    d, L = TOPN["d"], M_MAIN // SHARDS
    gx, groups, smem = P.apply_plan(xs.device, SHARDS, L, d, False)
    keep = torch.empty(M_MAIN, dtype=torch.bool, device="cuda")
    col = merged.data_ptr() + (merged.shape[1] - 1) * merged.stride(1) * 4

    def launch():
        P.TOPN_APPLY.launch(xs.device, ptr(xs), col, merged.stride(0),
                            ptr(keep), SHARDS, L, d, 0,
                            int(fam == "kernel"), 0, gx, groups, smem, None,
                            0)
    return launch, keep


def time_topn_det(torch, xs, totals):
    """The ladder scan against its plain version on the whole 2^25-row
    column at S = 1 (run_query, engine scan: the reported shape) and
    S = 128 (engine two_pass), state and all. Bound: bytes (read x, write
    keep and the lane states); the scan has no dependent chain of probes."""
    from repro_torch.kernels import topn_det_scan as TD

    m, w = xs.numel(), TOPN_DET["w"]
    errs, first = [], None
    for path, S, reps in (("run_query / engine_prune scan", 1, 5),
                          ("engine_prune two_pass", SHARDS, 20)):
        k, st = TD.topn_det_pass1_kernel(xs, shards=S, **TOPN_DET)
        (k2, st2), plain_s = sync_time(
            lambda: TD.topn_det_pass1_plain(xs.view(S, -1), **TOPN_DET))
        errs.append(max_abs_err([(k, k2.reshape(-1)), *zip(st, st2)]))
        check(errs[-1] == 0.0, f"topn_det_pass1 {path} on the 2^25-row table")
        ms = event_ms(lambda: TD.topn_det_pass1_kernel(xs, shards=S,
                                                       **TOPN_DET), reps,
                      warm=False)
        bound = (m * 4 + m + S * (4 * w + 12)) / HBM_BYTES_PER_S * 1e3
        say("timing", kernel="topn_det_pass1", path=json.dumps(path), S=S,
            ms=ms, plain_ms=plain_s * 1e3, bound_ms=bound, bound_by="bytes",
            kept=int(k.sum()), max_abs_err=errs[-1])
        first = first or (ms, plain_s * 1e3, bound, "bytes")
    return _row("topn_det_pass1", totals, max(errs), *first)


def time_lru(torch, P, R, fs, totals, clock_hz, host):
    """LRU pass 1 against its plain version at S = 1 (run_query, engine
    scan: the reported shape) and S = 128 (engine two_pass). At S = 128 on
    the whole table, keep and lane states (its plain loop run on the host
    by HostPlain); at S = 1 on the first SCAN_PREFIX entries, as the FIFO
    scan is (the full-size run's keep there, and the kernel rerun on the
    prefix state and all). Bound: the longest chain of the row-parallel
    walk on this stream (walk_bound)."""
    m, d, w = fs.numel(), DISTINCT["d"], DISTINCT["w"]
    errs, first = [], None
    for path, S, reps in (("run_query / engine_prune scan", 1, 5),
                          ("engine_prune two_pass", SHARDS, 5)):
        kw = dict(shards=S, block=1, policy="lru", **DISTINCT)
        full = P.distinct_shard_states_kernel(fs, **kw)
        if S == 1:
            n = SCAN_PREFIX
            pre = P.distinct_shard_states_kernel(fs[:n], **kw)
            (k2, st2), plain_s = sync_time(lambda: R.distinct_lru_ref(
                fs[:n].view(1, n), d=d, w=w, return_state=True))
            pairs = [(full[0][:n], k2.view(n)), (pre[0], k2.view(n)),
                     *zip(pre[1:], st2)]
        else:
            n = m
            (k2, st2), plain_s = host.get(("distinct_pass1_lru", S, 1))
            pairs = [(full[0].view(S, -1), k2), *zip(full[1:], st2)]
        errs.append(max_abs_err(pairs))
        check(errs[-1] == 0.0, f"distinct_pass1_lru {path} on the 2^25-row "
              "table")
        # the full-size run above was the warm-up
        ms = event_ms(lambda: P.distinct_shard_states_kernel(fs, **kw), reps,
                      warm=False)
        bound, by = walk_bound(torch, fs, S, d, None, bytes_ms(
            m * 4 + m + S * (d * w * 5 + d * 4)), clock_hz)
        say("timing", kernel="distinct_pass1_lru", path=json.dumps(path),
            S=S, B=1, ms=ms, compared_entries=n, plain_ms=plain_s * 1e3,
            plain_on="card" if S == 1 else "host", bound_ms=bound,
            bound_by=by, chain_steps=m // S,
            kept=int(full[0].sum()), max_abs_err=errs[-1])
        first = first or (ms, plain_s * 1e3, bound, by)
    return _row("distinct_pass1_lru", totals, max(errs), *first)


def rle_pruning_layouts(torch, rv, rl):
    """Layouts of the same 2^19 run values that prune, which the ascending
    bench layout does not (every run there clears the ladder): shuffled with
    lengths drawn in [1, 127]; the same shifted by -2048 to cross 0, so that
    t0 <= 0 and the ladder's levels are not a prefix (runs take the C
    branch); and descending."""
    import numpy as np

    R_ = rv.numel()
    sh = torch.from_numpy(np.random.default_rng(2).permutation(
        rv.cpu().numpy())).cuda()
    lr = torch.from_numpy(np.random.default_rng(3).integers(
        1, 128, R_).astype(np.int32)).cuda()
    return (("shuffled", sh, lr), ("shuffled - 2048", sh - 2048, lr),
            ("descending", rv.flip(0).contiguous(), rl))


def time_rle(torch, rv, rl, totals):
    """The run-level scan against its plain version on bench_encoded.py's
    2^19 runs (the timed shape), then on three layouts of the same runs
    that prune, each also against the flat ladder scan of its expanded
    column. Bound: bytes (read value and length, write head and tstar,
    once a run). Also the C entry's time without the wrapper: a call alone
    (the card idle between calls) and queued back to back, which is its
    device time where the host queues a call faster than the card runs
    it (the profiler does not record the cooperative launch)."""
    from repro_torch import core
    from repro_torch.kernels import ops as O
    from repro_torch.kernels import rle_scan as RS
    from repro_torch.kernels.common import I32, P as VP, ptr, workspace

    h, t = RS.rle_topn_det_kernel(rv, rl, **RLE_TOPN)
    (h2, t2), plain_s = sync_time(lambda: RS.rle_topn_det_ref(rv, rl,
                                                              **RLE_TOPN))
    errs = [max_abs_err([(h, h2), (t, t2)])]
    check(errs[0] == 0.0, "rle_topn_det at 2^19 runs")
    ms = event_ms(lambda: RS.rle_topn_det_kernel(rv, rl, **RLE_TOPN), 20,
                  warm=False)
    R_, N, w = rv.numel(), RLE_TOPN["N"], RLE_TOPN["w"]
    work = workspace(rv.device, "rle_topn_det_workspace", R_, w)
    hc, tc = torch.empty_like(h), torch.empty_like(t)

    def c_entry():
        """The C entry alone, without the wrapper's checks and workspace."""
        serial_kernel(torch, "rle_topn_det", [VP] * 4 + [I32] * 3 + [VP],
                      ptr(rv), ptr(rl), ptr(hc), ptr(tc), R_, N, w,
                      ptr(work))

    c_ms = event_ms(c_entry, 20)
    check(same(hc, h) and same(tc, t), "rle_topn_det: the C entry differs "
          "from the wrapper's")
    bound = rv.numel() * 16 / HBM_BYTES_PER_S * 1e3
    say("timing", kernel="rle_topn_det", layout="ascending", runs=rv.numel(),
        ms=ms, c_entry_ms=c_ms, c_entry_queued_ms=queued_ms(c_entry, 200),
        plain_ms=plain_s * 1e3, bound_ms=bound, bound_by="bytes",
        max_abs_err=errs[0])
    branches = torch.zeros(3, dtype=torch.int64, device="cuda")
    for name, v, L in rle_pruning_layouts(torch, rv, rl):
        h, t = RS.rle_topn_det_kernel(v, L, **RLE_TOPN)
        h2, t2 = RS.rle_topn_det_ref(v, L, **RLE_TOPN)
        errs.append(max_abs_err([(h, h2), (t, t2)]))
        check(errs[-1] == 0.0, f"rle_topn_det at 2^19 runs, {name}")
        total = int(L.sum())
        keep = O.rle_expand_mask(h, t, L, total)
        flat = core.rle_expand(v, L, total=total)
        check(torch.equal(keep, core.topn_det_prune(flat, **RLE_TOPN).keep),
              f"rle_topn_det {name}: the expanded mask differs from the "
              "flat ladder scan")
        # tstar = 1: no saturated level fails (A < 0); 2^30: only the head
        # is kept; else N - C (a ladder level above A catches the run)
        n = torch.stack([(t == 1).sum(), (t == RS.BIG).sum(),
                         ((t != 1) & (t != RS.BIG)).sum()])
        branches += n
        say("timing", kernel="rle_topn_det", layout=json.dumps(name),
            runs=v.numel(), rows=total, pruned_rows=total - int(keep.sum()),
            tstar_1=int(n[0]), tstar_big=int(n[1]), tstar_n_minus_c=int(n[2]),
            ms=event_ms(lambda: RS.rle_topn_det_kernel(v, L, **RLE_TOPN),
                        10), max_abs_err=errs[-1])
    check(bool((branches > 0).all()), "rle_topn_det: the pruning layouts do "
          "not reach all three tstar branches")
    return _row("rle_topn_det", totals, max(errs), ms, plain_s * 1e3, bound,
                "bytes")


def time_decode(torch, encoded):
    """The ``lut[code]`` gather that every encoded body runs at entry (a
    torch gather, not a kernel of the port), over the 2^25 codes of each
    dictionary column. Bound: bytes (read the codes, write the values,
    read the dictionary once)."""
    for name, cname in (("dict ad_revenue", "ad_revenue"),
                        ("dict source_ip", "source_ip")):
        col = encoded[name].col(cname)
        ms = event_ms(lambda: col.encoding.decode(col.codes), 20)
        nbytes = col.codes.numel() * 8 + col.encoding.lut.numel() * 4
        say("timing", kernel="lut[code] decode", column=json.dumps(name),
            codes=col.codes.numel(), dictionary=col.encoding.size, ms=ms,
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def time_skyline_apply(torch, P, pts, states, totals):
    """SKYLINE pass 2 after the S = 128 stores of B = 256 (ops, plain
    union) and of B = 1 (engine, union sorted by score)."""
    from repro_torch import core
    from repro_torch.constants import NEG

    m, D = pts.shape
    errs = []
    for key in ("skyline_pass1 ops", "skyline_pass1"):
        _, (sp, ss) = states[key]
        if key.endswith("ops"):
            mp, msc = P.merge_skyline_states(sp, ss)
        else:
            merged = core.merge_states("skyline", core.SkylineState(sp, ss),
                                       **SKYLINE)
            mp, msc = merged.points, merged.scores
        keep = P.skyline_apply_kernel(pts, mp, msc)
        keep2, plain_s = sync_time(lambda: P.skyline_apply_plain(pts, mp,
                                                                 msc))
        errs.append(max_abs_err([(keep, keep2)]))
        check(errs[-1] == 0.0, f"skyline_apply after {key} at 2^25 rows")
        # views that start 8 and 24 bytes into the column (no float4 load)
        for lo, hi in ((1, m), (3, 1001)):
            check(same(P.skyline_apply_kernel(pts[lo:hi], mp, msc),
                       keep2[lo:hi]), f"skyline_apply after {key} on the "
                  f"view pts[{lo}:{hi}] differs from the plain apply")
        ms = event_ms(lambda: P.skyline_apply_kernel(pts, mp, msc), 10)
        # the least work this run's data needs: a dominated entry one
        # dominator's D comparisons, a survivor D comparisons against each
        # of the k points of the compacted set; the full scan is m * S*w * D
        sw, valid, kept = msc.numel(), int((msc > NEG).sum()), int(keep.sum())
        k = P.skyline_compact_plain(mp, msc)[0].shape[0]
        compares = (m - kept) * D + kept * k * D
        t_ops = compares / FP32_OPS_PER_S * 1e3
        t_bytes = (m * D * 4 + m + sw * (D + 1) * 4) / HBM_BYTES_PER_S * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
        old = torch.empty(m, dtype=torch.bool, device="cuda")
        scan_ms = event_ms(lambda: skyline_scan(torch, pts, mp, msc, old), 10)
        check(same(old, keep), f"skyline_apply after {key}: the retired "
              "scan differs")
        say("timing", kernel="skyline_apply", after=json.dumps(key), ms=ms,
            device_ms=device_split(torch, lambda: P.skyline_apply_kernel(
                pts, mp, msc)),
            plain_ms=plain_s * 1e3, bound_ms=bound, bound_by=by, k=k,
            valid_points=valid, compares_needed=compares,
            compares_full=m * sw * D,
            retired_scan_ms=scan_ms,
            full_scan_ms=m * sw * D / FP32_OPS_PER_S * 1e3, survivors=kept,
            max_abs_err=errs[-1])
        if key.endswith("ops"):
            first = (ms, plain_s * 1e3, bound, by)
    return _row("skyline_apply", totals, max(errs), *first)


def skyline_scan(torch, pts, mp, msc, keep):
    """The retired SKYLINE apply (C entry skyline_apply_scan) into keep."""
    from repro_torch.kernels.common import I32, I64, P as VP, grid_for, ptr

    m, D = pts.shape
    serial_kernel(torch, "skyline_apply_scan", [VP] * 4 + [I64] + [I32] * 3,
                  ptr(pts), ptr(mp), ptr(msc), ptr(keep), m, D, msc.numel(),
                  grid_for(m, pts.device))
    return keep


def merged_skyline_sets(torch, P, pts):
    """(name, points, scores) of the two merged sets the main path's SKYLINE
    apply takes: the ops union of S = 128 stores at B = 256 (unsorted) and
    the engine's union of B = 1 stores, sorted by score."""
    from repro_torch import core

    _, sp, ss = P.skyline_shard_states_kernel(pts, shards=SHARDS, block=256,
                                              form="kernel", **SKYLINE)
    mp, msc = P.merge_skyline_states(sp, ss)
    _, ep, es = P.skyline_shard_states_kernel(pts, shards=SHARDS, block=1,
                                              form="engine", **SKYLINE)
    merged = core.merge_states("skyline", core.SkylineState(ep, es),
                               **SKYLINE)
    return [("ops union", mp, msc),
            ("engine union", merged.points, merged.scores)]


def cms_atomic(torch, keys, wts, rows, width, family, lanes):
    """The retired Count-Min build (C entry cms_build_atomic) into a zeroed
    table, with the CTAs a lane its wrapper gave it."""
    from repro_torch.kernels import cms_sketch as C
    from repro_torch.kernels.common import I32, U32, P as VP, ptr

    n = keys.numel() // lanes
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    ctas = max(1, min(-(-n // 256), -(-4 * sms // lanes)))
    w, is_int = C._kernel_weights(wts)
    out = torch.zeros((lanes, rows, width), device=keys.device,
                      dtype=torch.int32 if is_int else torch.float32)
    serial_kernel(torch, "cms_build_atomic", [VP] * 3 + [I32] * 4 + [U32]
                  + [I32] * 3, ptr(C._keys_u32(keys)),
                  None if w is None else ptr(w), ptr(out), lanes, n, rows,
                  width, 0, C._family(family, keys), is_int, ctas)
    return out


_SASS = {}


def sass_functions(torch):
    """{mangled kernel name: its SASS lines} of the built library, read once
    with cuobjdump -sass."""
    import os

    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import common

    if "funcs" not in _SASS:
        tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin",
                            "cuobjdump")
        res = subprocess.run([tool, "-sass", str(common.build())],
                             capture_output=True, text=True)
        funcs, fn = {}, None
        for line in res.stdout.splitlines():
            head = re.search(r"Function : (\S+)", line)
            if head:
                fn = head.group(1)
                funcs[fn] = []
            elif fn:
                funcs[fn].append(line)
        _SASS["funcs"], _SASS["rc"] = funcs, res.returncode
    return _SASS["funcs"]


def sass_atomics(torch):
    """{kernel: {atomic instruction: count}} of the Count-Min builds in the
    built library, read with cuobjdump: whether an f32 shared add is one
    ATOMS.ADD or a compare-and-swap loop."""
    out = {}
    for fn, lines in sass_functions(torch).items():
        if "cms_build" not in fn:
            continue
        for line in lines:
            ins = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED)\.[A-Z0-9._]+)", line)
            if ins:
                per = out.setdefault(fn, {})
                per[ins.group(1)] = per.get(ins.group(1), 0) + 1
    return out or {"cuobjdump_rc": _SASS.get("rc")}


def key_loop(torch, pattern, keys):
    """SASS instructions a key of the persistent query whose mangled name
    holds ``pattern``: the instructions of its key loop, the smallest loop
    (a backward branch to a label) that loads 16 bytes of keys and stores to
    global memory, over the ``keys`` a thread takes in it. A static count:
    every probe or row, whatever a key's early exit. None where no such
    loop is found."""
    name = next((n for n in sass_functions(torch) if pattern in n), None)
    if name is None:
        return None
    ins, labels, at = [], {}, {}
    for line in sass_functions(torch)[name]:
        lab = re.match(r"\s*\.?(L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ins)
            continue
        op = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if op:
            at[int(op.group(1), 16)] = len(ins)
            ins.append(op.group(2).strip())
    sizes = []
    for i, t in enumerate(ins):
        b = re.search(r"\bBRA(?:\.\S+)?\s+(?:`\(\.?(L_x_\d+)\)|(0x[0-9a-f]+))",
                      t)
        if not b:
            continue
        top = (labels.get(b.group(1)) if b.group(1)
               else at.get(int(b.group(2), 16)))
        if top is None or top > i:
            continue
        body = [x for x in ins[top:i + 1] if not x.endswith("NOP")]
        if (any(re.search(r"LDG\.E\S*\.128", x) for x in body)
                and any(re.search(r"\bSTG", x) for x in body)):
            sizes.append(len(body))
    return min(sizes) / keys if sizes else None


def host_call_us(torch, fn, reps=200):
    """Host microseconds a call of fn(), from calls queued back to back on
    a card that runs each faster than the host issues it (a few keys)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def cms_shapes(table):
    """(path, keys, weights, family, rows, width, lanes, threshold) of every
    Count-Min launch on the main path; the first is the reported shape."""
    import torch

    src, dur, lang = (table.cols["source_ip"], table.cols["duration"],
                      table.cols["lang"])
    ones = torch.ones(M_MAIN, dtype=torch.float32, device="cuda")
    cnt, sm = HAVING_COUNT[2], HAVING_SUM[2]
    return [("ops.cms_build / ops.cms_query", src, ones, "kernel",
             CMS_OPS["rows"], CMS_OPS["width"], 1, None),
            ("run_query HAVING COUNT", src, None, "engine", cnt["rows"],
             cnt["width"], 1, cnt["threshold"]),
            ("run_query HAVING SUM", lang, dur, "engine", sm["rows"],
             sm["width"], 1, sm["threshold"]),
            ("engine_prune two_pass HAVING COUNT", src, None, "engine",
             cnt["rows"], cnt["width"], SHARDS, cnt["threshold"])]


def cms_query_profile(torch, C, table_q, keys, qkw, clock_hz):
    """What phase timing prints of a persistent Count-Min query beside its
    call time: its device time (calls queued back to back), its route and
    CTAs, the SASS instructions a key of its key loop and the issue floor
    they imply (4 warp instructions a cycle an SM at the maximum clock),
    the host time of a call (on 4096 keys), and a yardstick that is not the
    same function: a torch gather of the counters at cells hashed before
    the timed call (table.view(-1)[cells], every row of every key)."""
    fn = lambda: C.cms_query_kernel(table_q, keys, **qkw)  # noqa: E731
    rows_, width = table_q.shape
    ttype = (0 if table_q.dtype.is_floating_point
             else 2 if table_q.dtype == torch.uint32 else 1)
    fam = C._family(qkw["family"], keys)
    route, ctas, _ = C.query_plan(keys.device, rows_, width, ttype, fam)
    unrolled = 3 if route and rows_ == 3 else 0
    pow2 = int(width & (width - 1) == 0)
    per_key = key_loop(torch, f"cms_query_persistentI{'fij'[ttype]}Li{fam}"
                       f"ELi{unrolled}ELb{route}ELb{pow2}EE", 8)
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    cells = (C.row_hashes(keys, rows_, width, 0, qkw["family"])
             + torch.arange(rows_, device="cuda") * width).reshape(-1)
    flat = table_q.reshape(-1)
    small = keys[:4096]
    return dict(
        device_ms=queued_ms(fn, 20), route="staged" if route else "global",
        ctas=ctas, sass_per_key=per_key,
        issue_floor_ms=None if per_key is None
        else per_key * keys.numel() / (sms * 128 * clock_hz) * 1e3,
        host_us=host_call_us(torch, lambda: C.cms_query_kernel(
            table_q, small, **qkw)),
        gather_hashed_cells_ms=event_ms(lambda: flat[cells], 10),
        # what each call paid when the wrapper asked the SM count itself
        device_properties_us=host_call_us(
            torch, lambda: torch.cuda.get_device_properties(keys.device)))


def time_cms(torch, table, totals, clock_hz):
    """Both Count-Min kernels against their plain versions at every
    main-path shape; bound by bytes. The query of the two-pass path reads
    the merged table of its S = 128 lane tables; its profile is
    ``cms_query_profile``'s."""
    from repro_torch import core
    from repro_torch.kernels import cms_sketch as C

    m = M_MAIN
    errs_b, errs_q, out = [], [], []
    for path, keys, wts, fam, rows_, width, lanes, thr in cms_shapes(table):
        kw = dict(rows=rows_, width=width, family=fam, shards=lanes)
        tb = C.cms_build_kernel(keys, wts, **kw)
        tb2, plain_b = sync_time(lambda: C.cms_build_plain(keys, wts, **kw))
        errs_b.append(max_abs_err([(tb, tb2)]))
        check(errs_b[-1] == 0.0, f"cms_build {path} at 2^25 rows")
        ms_b = event_ms(lambda: C.cms_build_kernel(keys, wts, **kw), 10)
        wbytes = 0 if wts is None else m * 4
        bound_b = (m * 4 + wbytes + tb.numel() * 4) / HBM_BYTES_PER_S * 1e3
        table_q = core.merge_states("having", core.CountMin(tb)).table
        qkw = dict(family=fam, threshold=thr)
        est = C.cms_query_kernel(table_q, keys, **qkw)
        est2, plain_q = sync_time(lambda: C.cms_query_plain(table_q, keys,
                                                            **qkw))
        errs_q.append(max_abs_err([(est, est2)]))
        check(errs_q[-1] == 0.0, f"cms_query {path} at 2^25 rows")
        ms_q = event_ms(lambda: C.cms_query_kernel(table_q, keys, **qkw), 10)
        bound_q = ((m * 4 + table_q.numel() * 4
                    + m * est.element_size()) / HBM_BYTES_PER_S * 1e3)
        query_extra = cms_query_profile(torch, C, table_q, keys, qkw,
                                        clock_hz)
        # a yardstick, not the same function: index_add_ of the weights on
        # cells whose hashes are computed before the timed call
        cells = (C.row_hashes(keys, rows_, width, 0, fam)
                 + torch.arange(rows_, device="cuda") * width).reshape(-1)
        w_rep = (torch.ones(m * rows_, dtype=torch.float32, device="cuda")
                 if wts is None else wts.float().repeat_interleave(rows_))
        acc = torch.zeros(rows_ * width, dtype=torch.float32, device="cuda")
        scatter_ms = event_ms(lambda: acc.index_add_(0, cells, w_rep), 10)
        ctas, shadow, _ = C.build_plan(keys.device, lanes, m // lanes, rows_,
                                       width, int(tb.dtype != torch.float32))
        say("timing", kernel="cms_build", path=json.dumps(path), lanes=lanes,
            width=width, dtype=str(tb.dtype), ms=ms_b,
            plain_ms=plain_b * 1e3, bound_ms=bound_b, bound_by="bytes",
            ctas=ctas, shadow_limit=shadow,
            device_ms=device_split(torch, lambda: C.cms_build_kernel(
                keys, wts, **kw)),
            index_add_on_hashed_cells_ms=scatter_ms,
            max_abs_err=errs_b[-1])
        say("timing", kernel="cms_query", path=json.dumps(path),
            fused_threshold=thr is not None, ms=ms_q, plain_ms=plain_q * 1e3,
            bound_ms=bound_q, bound_by="bytes", max_abs_err=errs_q[-1],
            **query_extra)
        if not out:
            out = [(ms_b, plain_b * 1e3, bound_b), (ms_q, plain_q * 1e3,
                                                    bound_q)]
    say("timing", kernel="cms_build", sass_atomics=json.dumps(
        sass_atomics(torch)))
    return [_row("cms_build", totals, max(errs_b), *out[0], "bytes"),
            _row("cms_query", totals, max(errs_q), *out[1], "bytes")]


def bloom_shapes(table, rankings):
    """(path, keys, family, nbits, seed) of every Bloom build on the main
    path, the reported shape first; each query probes the other side's
    filter (JOIN) or the ops filter with every dest_url."""
    dest, page = table.cols["dest_url"], rankings.cols["page_url"]
    nb = JOIN["nbits"]
    return [("run_query JOIN F_A (dest_url)", dest, "engine", nb, 0),
            ("run_query JOIN F_B (page_url)", page, "engine", nb, 7919),
            ("ops.bloom_build (page_url[:4096])", page[:BLOOM_OPS_KEYS],
             "kernel", BLOOM_OPS["nbits"], 0)]


def bloom_global(torch, keys, words, kw, mask=None):
    """The retired global-atomic build (the C entry bloom_build_global,
    which the wrapper takes only for filters of 48 KB or less, staged, or
    too large for a cluster) into ``words``, zeroed first."""
    from repro_torch.kernels import bloom_filter as B
    from repro_torch.kernels.common import I32, I64, P as VP, U32, grid_for, \
        ptr

    words.zero_()
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    serial_kernel(torch, "bloom_build_global", [VP] * 3 + [I64, U32, I32,
                                                           U32, I32, I32],
                  ptr(keys), None if mask is None else ptr(mask), ptr(words),
                  keys.numel(), kw["nbits"], kw["num_hashes"],
                  kw["seed"] & 0xFFFFFFFF,
                  B._family(kw["family"], kw["nbits"], keys),
                  min(grid_for(keys.numel(), keys.device), 4 * sms))


def bloom_cluster(torch, keys, words, kw, mask=None):
    """The cluster build (the C entry bloom_build) into ``words``, zeroed
    first, whatever route the wrapper takes for the shape; K and the
    clusters from bloom_cluster_plan, as the wrapper takes them."""
    from repro_torch.kernels import bloom_filter as B
    from repro_torch.kernels.common import I32, I64, P as VP, U32, ptr

    K, _, most = B.cluster_plan(keys.device, kw["nbits"], kw["num_hashes"])
    check(K > 0, f"no cluster holds a filter of {kw['nbits']} bits")
    words.zero_()
    if keys.numel():
        serial_kernel(torch, "bloom_build", [VP] * 3 + [I64, U32, I32, U32,
                                                         I32, I32, I32],
                      ptr(keys), None if mask is None else ptr(mask),
                      ptr(words), keys.numel(), kw["nbits"],
                      kw["num_hashes"], kw["seed"] & 0xFFFFFFFF,
                      B._family(kw["family"], kw["nbits"], keys), K, most)


def bloom_plan_k(torch, nbits, H):
    """The K that the wrapper routes by: 0 for a staged filter."""
    from repro_torch.kernels import bloom_filter as B

    if B.num_words(nbits) * 4 <= B.STAGED_BYTES:
        return 0
    return B.cluster_plan(torch.device("cuda", torch.cuda.current_device()),
                          nbits, H)[0]


def time_bloom_sweep(torch, table):
    """The readings of the wrapper's dispatch rule: the cluster build
    against the global atomics (both by their C entries, each into a zeroed
    filter) at JOIN's filter size, over m from 2^14 to 2^23 keys of
    dest_url, by probes a filter word; the device split of both from 2^16
    to 2^22 keys."""
    from repro_torch.kernels import bloom_filter as B

    H, nbits = JOIN["num_hashes"], JOIN["nbits"]
    kw = dict(nbits=nbits, num_hashes=H, seed=0, family="engine")
    nw = B.num_words(nbits)
    K = bloom_plan_k(torch, nbits, H)
    a = torch.empty(nw, dtype=torch.uint32, device="cuda")
    b = torch.empty_like(a)
    for lg in range(14, 24):
        k = table.cols["dest_url"][:1 << lg]
        c_ms = event_ms(lambda: bloom_cluster(torch, k, a, kw), 10)
        g_ms = event_ms(lambda: bloom_global(torch, k, b, kw), 10)
        check(same(a, b), f"bloom_build sweep m=2^{lg}: the cluster build "
              "differs from the global atomics")
        extra = {}
        if 16 <= lg <= 22:
            extra = dict(
                cluster_device_ms=device_split(
                    torch, lambda: bloom_cluster(torch, k, a, kw)),
                global_device_ms=device_split(
                    torch, lambda: bloom_global(torch, k, b, kw)))
        say("timing", sweep="bloom_build", keys=1 << lg, nbits=nbits,
            probes_per_word=(1 << lg) * H / nw, cluster_ms=c_ms,
            global_ms=g_ms, route=B.bloom_route(nbits, H, 1 << lg, K),
            **extra)


def bloom_query_profile(torch, B, words, keys, kw, clock_hz):
    """What phase timing prints of a persistent Bloom query beside its call
    time, as ``cms_query_profile``: device time, route and CTAs, SASS
    instructions a key and the issue floor, host time, the probes a key
    takes (each key stops at its first unset bit), and a yardstick that is
    not the same function: a torch gather of the words at the probes
    hashed before the timed call (words[idx >> 5], every probe of every
    key), with the rate of its 32-byte sectors (a random word read moves
    one sector), which for a JOIN filter is the card's L2 gather rate."""
    fn = lambda: B.bloom_query_kernel(words, keys, **kw)  # noqa: E731
    H, nbits = kw["num_hashes"], kw["nbits"]
    fam = B._family(kw["family"], nbits, keys)
    route, ctas = B.query_plan(keys.device, nbits, H, fam)
    pow2 = int(nbits & (nbits - 1) == 0)
    per_key = key_loop(torch, f"bloom_query_persistentILi{fam}ELi"
                       f"{3 if H == 3 else 0}ELb{route}ELb{pow2}EE", 8)
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    idx = B.probe_bits(keys, **kw)
    w32 = words.view(torch.int32)
    got = (w32[idx >> 5] >> (idx & 31)) & 1
    # probes taken: the first, and each next while every earlier was set
    probes = float(got.cumprod(1)[:, :-1].sum() + keys.numel()) \
        / keys.numel()
    flat = (idx >> 5).reshape(-1)
    gather = event_ms(lambda: w32[flat], 10)
    return dict(
        device_ms=queued_ms(fn, 20), route="staged" if route else "global",
        ctas=ctas, sass_per_key=per_key,
        issue_floor_ms=None if per_key is None
        else per_key * keys.numel() / (sms * 128 * clock_hz) * 1e3,
        host_us=host_call_us(torch, lambda: B.bloom_query_kernel(
            words, keys[:4096], **kw)),
        probes_per_key=probes, gather_hashed_words_ms=gather,
        gather_sectors_per_s=flat.numel() / (gather * 1e-3))


def time_bloom(torch, table, rankings, totals, clock_hz):
    """Both Bloom kernels against their plain versions at every main-path
    shape; bound by bytes (keys read once, bitset or keep written once).
    The cluster build (JOIN's filters) also beside the global-atomic kernel
    it replaced, with the device split of its launches; the staged kernel
    (ops.bloom_build) has a row of its own."""
    from repro_torch.kernels import bloom_filter as B

    H = JOIN["num_hashes"]
    built = {}
    errs_b, errs_g, errs_q, out = [], [], [], {}
    for path, keys, fam, nbits, seed in bloom_shapes(table, rankings):
        kw = dict(nbits=nbits, num_hashes=H, seed=seed, family=fam)
        K = bloom_plan_k(torch, nbits, H)
        route = B.bloom_route(nbits, H, keys.numel(), K)
        w = B.bloom_build_kernel(keys, **kw)
        w2, plain_s = sync_time(lambda: B.bloom_build_plain(keys, **kw))
        (errs_b if route == "cluster" else errs_g).append(
            max_abs_err([(w, w2)]))
        check(max_abs_err([(w, w2)]) == 0.0, f"bloom_build {path}")
        built[path] = (w, kw)
        ms = event_ms(lambda: B.bloom_build_kernel(keys, **kw), 10)
        bound = (keys.numel() * 4 + w.numel() * 4) / HBM_BYTES_PER_S * 1e3
        # a yardstick, not the same function: index_put_ of True at bits
        # hashed before the timed call, into a bool[nbits] vector
        idx = B.probe_bits(keys, **kw).reshape(-1)
        bits = torch.zeros(nbits, dtype=torch.bool, device="cuda")
        one = torch.ones((), dtype=torch.bool, device="cuda")
        put_ms = event_ms(lambda: bits.index_put_((idx,), one), 10)
        extra = {}
        if K:
            scratch = torch.empty_like(w)
            _, sl, most = B.cluster_plan(keys.device, nbits, H)
            extra = dict(
                K=K, slice_bytes=sl * 4, max_clusters=most,
                cluster_ms=event_ms(lambda: bloom_cluster(torch, keys,
                                                          scratch, kw), 10),
                global_ms=event_ms(lambda: bloom_global(torch, keys, scratch,
                                                        kw), 10))
        say("timing", kernel="bloom_build", path=json.dumps(path),
            route=route, keys=keys.numel(), nbits=nbits, family=fam, ms=ms,
            plain_ms=plain_s * 1e3, bound_ms=bound, bound_by="bytes",
            index_put_on_hashed_bits_ms=put_ms, max_abs_err=errs_b[-1]
            if route == "cluster" else errs_g[-1], **extra)
        if K:
            say("timing", profile="bloom_build", path=json.dumps(path),
                route=route, device_ms=device_split(
                    torch, lambda: B.bloom_build_kernel(keys, **kw)))
        out.setdefault("build" if route == "cluster" else "build_global",
                       (ms, plain_s * 1e3, bound))
    (fa, kwa), (fb, kwb), (fo, kwo) = built.values()
    dest, page = table.cols["dest_url"], rankings.cols["page_url"]
    for path, words, keys, kw in (
            ("run_query JOIN keep_a (F_B on dest_url)", fb, dest, kwb),
            ("run_query JOIN keep_b (F_A on page_url)", fa, page, kwa),
            ("ops.bloom_query (dest_url)", fo, dest, kwo)):
        keep = B.bloom_query_kernel(words, keys, **kw)
        keep2, plain_s = sync_time(lambda: B.bloom_query_plain(words, keys,
                                                               **kw))
        errs_q.append(max_abs_err([(keep, keep2)]))
        check(errs_q[-1] == 0.0, f"bloom_query {path}")
        ms = event_ms(lambda: B.bloom_query_kernel(words, keys, **kw), 10)
        bound = ((keys.numel() * 5 + words.numel() * 4) / HBM_BYTES_PER_S
                 * 1e3)
        say("timing", kernel="bloom_query", path=json.dumps(path),
            keys=keys.numel(), positives=int(keep.sum()), ms=ms,
            plain_ms=plain_s * 1e3, bound_ms=bound, bound_by="bytes",
            max_abs_err=errs_q[-1],
            **bloom_query_profile(torch, B, words, keys, kw, clock_hz))
        out.setdefault("query", (ms, plain_s * 1e3, bound))
    return [_row("bloom_build", totals, max(errs_b), *out["build"], "bytes"),
            _row("bloom_build_global", totals, max(errs_g),
                 *out["build_global"], "bytes"),
            _row("bloom_query", totals, max(errs_q), *out["query"], "bytes")]


def time_groupby(torch, table, totals, clock_hz):
    """The GROUP BY scan against its plain version at every main-path shape:
    the 128-lane COUNT of engine_prune two_pass (reported) and the one-lane
    SUM and COUNT scans of run_query. The emissions of entry i of a lane
    depend only on the lane's entries up to i, so the plain scan of each
    lane's first GROUPBY_PREFIX / S entries (SCAN_PREFIX at S = 1) checks
    the full-size run's emissions there, and the kernel rerun on that
    prefix is checked state and all; phase_witness holds the one-lane
    scans against the retired serial kernel on the whole column. Bound:
    the longest chain of the row-parallel walk on this stream (walk_bound),
    or bytes (read keys and values, write the emissions and the caches)."""
    from repro_torch.kernels import groupby_scan as G

    keys, vals = table.cols["source_ip"], table.cols["ad_revenue"]
    m = M_MAIN
    errs, first = [], None
    for path, agg, S, reps in (
            ("engine_prune two_pass GROUP BY COUNT", "count", SHARDS, 5),
            ("run_query GROUP BY SUM (scan)", "sum", 1, 5),
            ("run_query GROUP BY COUNT (scan)", "count", 1, 5)):
        kw = dict(agg=agg, **GROUPBY)
        n = (GROUPBY_PREFIX if S > 1 else SCAN_PREFIX) // S
        kp = keys.view(S, -1)[:, :n].contiguous()
        vp = vals.view(S, -1)[:, :n].contiguous()
        evp, stp = G.groupby_pass1_kernel(kp.view(-1), vp.view(-1), shards=S,
                                          **kw)
        # the reported (first) shape's plain loop runs on the card, the
        # others on the host (on_host)
        host = first is not None
        (ev2, st2), plain_s = (
            on_host(lambda a, b: G.groupby_pass1_plain(a, b, None, **kw),
                    kp, vp) if host
            else sync_time(lambda: G.groupby_pass1_plain(kp, vp, None, **kw)))
        pairs = [(a.view(S, n), b) for a, b in zip(evp, ev2)] + list(
            zip(stp, st2))
        ev, _ = G.groupby_pass1_kernel(keys, vals, shards=S, **kw)
        pairs += [(a.view(S, -1)[:, :n], b) for a, b in zip(ev, ev2)]
        errs.append(max_abs_err(pairs))
        err = errs[-1]
        check(err == 0.0, f"groupby_pass1 {path} on the 2^25-row table")
        # the full-size run above was the warm-up
        ms = event_ms(lambda: G.groupby_pass1_kernel(keys, vals, shards=S,
                                                     **kw), reps, warm=False)
        # COUNT's running values over a run of one key are a + i, exact in
        # f32 below 2^24 entries a row: no chain of folds
        bound, by = walk_bound(torch, keys, S, GROUPBY["d"],
                               None if agg == "count" else FADD_CYCLES,
                               bytes_ms(m * 8 + m * 9 + S * GROUPBY["d"]
                                        * GROUPBY["w"] * 9), clock_hz)
        say("timing", kernel="groupby_pass1", path=json.dumps(path), S=S,
            B=1, ms=ms, compared_entries=S * n, plain_ms=plain_s * 1e3,
            plain_on="host" if host else "card", bound_ms=bound, bound_by=by,
            chain_steps=m // S, max_abs_err=err)
        first = first or (ms, plain_s * 1e3, bound, by)
    return _row("groupby_pass1", totals, max(errs), *first)


def walk_bound(torch, keys, S, d, fold_cycles, bytes_ms, clock_hz):
    """(ms, what sets it) of the least time of a row-parallel walk over
    this stream: the larger of ``bytes_ms`` and its longest dependent
    chain. An entry touches only its own (lane, row) segment, so the chain
    is the costliest segment's: REG_STEP_CYCLES for each entry whose key
    differs from its segment predecessor's (the walk keeps the row in
    registers), and for each repeat ``fold_cycles``: None where a repeat
    needs no dependent step (DISTINCT drops it; GROUP BY COUNT's running
    values are a + i), else one fold (GROUP BY SUM, MIN, MAX: the order of
    the folds fixes the result's bits). The segments come from a stable
    sort here, which is bookkeeping of this measurement, not a step of the
    kernel."""
    from repro_torch.core.hashing import as_u32, hash_mod

    n = keys.numel() // S
    seg = (torch.arange(S, device=keys.device).repeat_interleave(n) * d
           + hash_mod(keys, d, 0))
    order = torch.sort(seg, stable=True).indices
    ss, kk = seg[order], as_u32(keys)[order]
    new = torch.ones_like(ss, dtype=torch.bool)
    new[1:] = (ss[1:] != ss[:-1]) | (kk[1:] != kk[:-1])
    cost = torch.where(new, float(REG_STEP_CYCLES), float(fold_cycles or 0))
    cycles = float(torch.bincount(ss, weights=cost.double(),
                                  minlength=S * d).max())
    t_chain = cycles / clock_hz * 1e3
    say("timing", walk_chain_cycles=cycles, S=S, d=d,
        segment_steps_max=int(torch.bincount(ss[new], minlength=S * d).max()))
    return (bytes_ms, "bytes") if bytes_ms >= t_chain else (t_chain, "chain")


def block_walk_bound(torch, keys, keep, S, B, d, io_ms, clock_hz):
    """(ms, what sets it) of the least time of the DISTINCT block walk on
    this stream: the larger of ``io_ms`` and the costliest (lane, row)
    segment's chain, REG_STEP_CYCLES for each of its groups (row, block)
    that insert. A group inserts exactly when one of its entries is kept
    (a kept entry missed the row as it stood before the block, and the
    first such entry inserts), so the groups come from this run's keep
    mask, which phase timing holds to the plain version."""
    from repro_torch.core.hashing import hash_mod

    n = keys.numel() // S
    nb = n // B
    idx = torch.arange(keys.numel(), device=keys.device)
    seg = (idx // n) * d + hash_mod(keys, d, 0)
    groups = torch.unique((seg * nb + (idx % n) // B)[keep])
    per_seg = torch.bincount(groups // nb, minlength=S * d)
    steps = int(per_seg.max())
    t_chain = steps * REG_STEP_CYCLES / clock_hz * 1e3
    say("timing", kernel="distinct_pass1_block_walk", S=S, B=B,
        inserting_groups=int(groups.numel()), segment_inserts_max=steps,
        chain_ms=t_chain)
    return (io_ms, "bytes") if io_ms >= t_chain else (t_chain, "chain")


def profile_walks(torch, table, pts):
    """Device time of each internal kernel of the redesigned pass-1 kernels
    on the 2^25-row table (torch.profiler, one traced run after a warm-up):
    the chunked ladder, the DISTINCT and TOP-N block walks (B = 256), the
    row-parallel walks (LRU DISTINCT, GROUP BY SUM, TOP-N at B = 1) and the
    SKYLINE prefix merge (B = 1 and B = 256), at S = 1 and S = 128."""
    from repro_torch.kernels import groupby_scan as G
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import topn_det_scan as TD

    fs, xs = table.cols["source_ip"], table.cols["ad_revenue"]
    for S in (1, SHARDS):
        for name, fn in (
                ("topn_det_pass1", lambda: TD.topn_det_pass1_kernel(
                    xs, shards=S, **TOPN_DET)),
                ("distinct_pass1_block_walk",
                 lambda: P.distinct_block_walk_kernel(
                     fs, shards=S, block=256, **DISTINCT)),
                ("distinct_pass1_lru", lambda: P.distinct_shard_states_kernel(
                    fs, shards=S, block=1, policy="lru", **DISTINCT)),
                ("groupby_pass1", lambda: G.groupby_pass1_kernel(
                    fs, xs, shards=S, agg="sum", **GROUPBY)),
                ("topn_pass1", lambda: P.topn_shard_states_kernel(
                    xs, shards=S, block=1, **TOPN)),
                ("topn_pass1_block_walk", lambda: P.topn_block_walk_kernel(
                    xs, shards=S, block=256, **TOPN)),
                ("skyline_pass1", lambda: P.skyline_shard_states_kernel(
                    pts, shards=S, block=1, form="engine", **SKYLINE)),
                ("skyline_pass1 B=256", lambda: P.skyline_shard_states_kernel(
                    pts, shards=S, block=256, form="kernel", **SKYLINE))):
            say("timing", profile=name, S=S, device_ms=device_split(torch, fn))


def device_split(torch, fn, runs=5, tries=3):
    """The device ms of each internal kernel of one run of fn(), traced by
    torch.profiler after a warm-up, as a JSON object. The profiler drops
    records of short runs: traced as its first step, a run lost its first
    launches, and now and then a whole trace came back empty. So its
    warm-up step is discarded, the traced step holds ``runs`` runs (a
    kernel's time a run is its mean time a launch times its launches a
    run, the count rounded, so that a lost record does not bias it), and
    an empty trace is taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    parts = {}

    def read(prof):
        for e in prof.key_averages():
            if e.device_time_total > 0:
                hit = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
                key = hit.group(1) if hit else e.key
                per_run = (e.device_time_total / e.count / 1e3
                           * max(1, round(e.count / runs)))
                parts[key] = round(parts.get(key, 0.0) + per_run, 4)

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=read) as prof:
            for step in range(2):
                for _ in range(runs if step else 1):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        if parts:
            break
    return json.dumps(parts, separators=(",", ":"))


def time_ascending(torch, P):
    """The redesigned B = 1 kernels' worst stream: ascending values, so that
    every entry inserts (the TOP-N walk takes a step an entry, the SKYLINE
    replay a round an entry), at S = 1 on M_MAIN entries; its time, kept
    count, and for SKYLINE its final store (the last w points). The values
    are the floats from 1.0 up, one ulp apart (consecutive bit patterns),
    and SKYLINE scores them by SUM, so that no two entries tie."""
    v = (torch.arange(M_MAIN, dtype=torch.int32, device="cuda")
         + 0x3F800000).view(torch.float32)
    pts = torch.stack([v, v], 1)
    w = SKYLINE["w"]
    for name, fn in (
            ("topn_pass1", lambda: P.topn_shard_states_kernel(
                v, shards=1, block=1, **TOPN)),
            ("skyline_pass1", lambda: P.skyline_shard_states_kernel(
                pts, shards=1, block=1, w=w, score="sum", form="engine"))):
        out = fn()
        ms = event_ms(fn, 1, warm=False)
        ok = bool(out[0].all())
        if name == "skyline_pass1":
            ok &= bool(torch.equal(out[1][0], pts[-w:].flip(0)))
        check(ok, f"{name} on an ascending stream: every entry is kept and "
              "the last entries are stored")
        say("timing", kernel=name, stream="ascending", S=1, B=1,
            entries=M_MAIN, ms=ms, kept=int(out[0].sum()))


def serial_kernel(torch, name, argtypes, *args):
    """Launch a kernel of the library by its C entry, outside its wrapper,
    so that its launch count does not move: a retired serial kernel (no
    entry point of the package reaches it), or a kernel at a shape its
    wrapper routes elsewhere; raises on a refused launch."""
    from repro_torch.kernels.common import I32, P, library_fn

    fn = library_fn(name, argtypes + [P], I32)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed to launch: cudaError {err}")


def phase_witness(torch, table, rankings, pts, rle):
    """The redesigned kernels against the serial kernels they replaced,
    bit for bit, on the whole 2^25-entry columns. The row-parallel walks at
    S = 1 on source_ip: DISTINCT FIFO and LRU (keep, slots, valid, head)
    and GROUP BY SUM and COUNT of ad_revenue (emissions and cache); the hot
    row holds a quarter of the stream, which is where a row-parallel walk
    can go wrong. The chunked ladder on ad_revenue against the one-CTA-a-
    lane ladder (topn_det_pass1_serial) and the DISTINCT block walk at
    B = 256 on source_ip against the one-CTA-a-lane block kernel (the C
    entry distinct_pass1), at S = 1 and S = 128; the TOP-N block walk at
    B = 256 on ad_revenue against its block kernel (the C entry topn_pass1)
    at S = 1 and 128; the staged block kernels (the C entries topn_pass1
    and distinct_pass1 at B = 256) against the unstaged block kernels they
    replaced (topn_pass1_block_unstaged, distinct_pass1_block_unstaged) at
    S = 1 and 128; the lowest-owner distinct_apply against the scan it
    replaced (the C entry distinct_apply_scan) at S = 128, after FIFO
    pass 1 at B = 256 and B = 1 and LRU pass 1. Then the B = 1 TOP-N walk
    on ad_revenue and the SKYLINE prefix merge on (ad_revenue, duration),
    at S = 1 and S = 128 (keep and every lane's final state): the chunk
    merges and replays run over the whole column. Then the chunked RLE run
    scan against the one-CTA run scan (rle_topn_det_serial) on the 2^19
    timed runs and the three pruning layouts, and the cluster Bloom build
    against the global-atomic kernel (bloom_build_global) at JOIN's F_A and
    F_B."""
    from repro_torch.kernels import groupby_scan as G
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels import topn_det_scan as TD
    from repro_torch.kernels.common import (I32, I64, P as VP, U32, grid_for,
                                            ptr)

    fs, xs = table.cols["source_ip"], table.cols["ad_revenue"]
    m, d, w = M_MAIN, DISTINCT["d"], DISTINCT["w"]
    for policy in ("fifo", "lru"):
        new = P.distinct_shard_states_kernel(fs, shards=1, block=1,
                                             policy=policy, **DISTINCT)
        old = (torch.empty(m, dtype=torch.bool, device="cuda"),
               torch.empty((1, d, w), dtype=torch.uint32, device="cuda"),
               torch.empty((1, d, w), dtype=torch.bool, device="cuda"),
               torch.empty((1, d), dtype=torch.int32, device="cuda"))
        _, secs = sync_time(lambda: serial_kernel(
            torch, "distinct_pass1_serial", [VP] * 5 + [I32] * 5 + [U32],
            *(ptr(t) for t in (fs,) + old), 1, m, d, w,
            int(policy == "lru"), 0))
        err = max_abs_err(zip(new, old))
        check(err == 0.0 and all(same(a, b) for a, b in zip(new, old)),
              f"distinct_pass1 {policy} differs from the serial "
              "kernel on the 2^25-entry column")
        say("witness", kernel="distinct_pass1", policy=policy, entries=m,
            serial_s=secs, kept=int(new[0].sum()), max_abs_err=err)
    for agg in ("sum", "count"):
        ev, st = G.groupby_pass1_kernel(fs, xs, agg=agg, **GROUPBY)
        old_ev = (torch.empty(m, dtype=torch.uint32, device="cuda"),
                  torch.empty(m, dtype=torch.float32, device="cuda"),
                  torch.empty(m, dtype=torch.bool, device="cuda"))
        old_st = G.init_state(1, GROUPBY["d"], GROUPBY["w"], agg, "cuda")
        _, secs = sync_time(lambda: serial_kernel(
            torch, "groupby_pass1_serial", [VP] * 9 + [I32] * 5 + [U32],
            ptr(fs), ptr(xs), None, *(ptr(t) for t in old_ev + old_st), 1,
            m, GROUPBY["d"], GROUPBY["w"], G.AGGS.index(agg), 0))
        err = max_abs_err(zip(ev + st, old_ev + old_st))
        check(err == 0.0 and all(same(a, b) for a, b in zip(
            ev + st, old_ev + old_st)), f"groupby_pass1 {agg} differs from "
              "the serial "
              "kernel on the 2^25-entry column")
        say("witness", kernel="groupby_pass1", agg=agg, entries=m,
            serial_s=secs, emitted=int(ev[2].sum()), max_abs_err=err)
    N, wl = TOPN_DET["N"], TOPN_DET["w"]
    for S in (1, SHARDS):
        new = TD.topn_det_pass1_kernel(xs, shards=S, **TOPN_DET)
        new = (new[0],) + new[1]
        old = (torch.empty(m, dtype=torch.bool, device="cuda"),
               torch.empty(S, dtype=torch.float32, device="cuda"),
               torch.empty((S, wl), dtype=torch.int32, device="cuda"),
               torch.empty(S, dtype=torch.int32, device="cuda"),
               torch.empty(S, dtype=torch.int32, device="cuda"))
        _, secs = sync_time(lambda: serial_kernel(
            torch, "topn_det_pass1_serial", [VP] * 6 + [I32] * 4,
            *(ptr(t) for t in (xs,) + old), S, m // S, N, wl))
        err = max_abs_err(zip(new, old))
        check(err == 0.0 and all(same_bits(a, b) for a, b in zip(new, old)),
              f"topn_det_pass1 S={S} differs from the serial ladder on the "
              "2^25-entry column")
        say("witness", kernel="topn_det_pass1", S=S, entries=m,
            serial_s=secs, kept=int(new[0].sum()), max_abs_err=err)
    for S in (1, SHARDS):
        new = P.distinct_block_walk_kernel(fs, shards=S, block=256,
                                           **DISTINCT)
        old, secs = sync_time(lambda: distinct_block_kernel(
            torch, fs, S, d, w, 256, 0))
        err = max_abs_err(zip(new, old))
        check(err == 0.0 and all(same(a, b) for a, b in zip(new, old)),
              f"distinct_pass1 block walk S={S} B=256 differs from the "
              "block kernel on the 2^25-entry column")
        say("witness", kernel="distinct_pass1_block_walk", S=S, B=256,
            entries=m, block_kernel_s=secs, kept=int(new[0].sum()),
            max_abs_err=err)
    for S in (1, SHARDS):
        new = P.topn_block_walk_kernel(xs, shards=S, block=256, **TOPN)
        old, secs = sync_time(lambda: topn_block_kernel(
            torch, xs, S, TOPN["d"], TOPN["w"], 256, 0))
        err = max_abs_err(zip(new, old))
        check(err == 0.0 and all(same_bits(a, b) for a, b in zip(new, old)),
              f"topn_pass1 block walk S={S} B=256 differs from the block "
              "kernel on the 2^25-entry column")
        say("witness", kernel="topn_pass1_block_walk", S=S, B=256,
            entries=m, block_kernel_s=secs, kept=int(new[0].sum()),
            max_abs_err=err)
    for S in (1, SHARDS):
        for name, fn in (("topn_pass1_block", lambda entry: topn_block_kernel(
                torch, xs, S, TOPN["d"], TOPN["w"], 256, 0, entry)),
                         ("distinct_pass1_block",
                          lambda entry: distinct_block_kernel(
                              torch, fs, S, d, w, 256, 0, entry))):
            new, new_s = sync_time(lambda: fn(name.split("_block")[0]))
            old, secs = sync_time(lambda: fn(name + "_unstaged"))
            err = max_abs_err(zip(new, old))
            check(err == 0.0 and all(same_bits(a, b)
                                     for a, b in zip(new, old)),
                  f"{name} S={S} B=256 differs from the unstaged block "
                  "kernel it replaced on the 2^25-entry column")
            say("witness", kernel=name, S=S, B=256, entries=m, staged_s=new_s,
                unstaged_s=secs, kept=int(new[0].sum()), max_abs_err=err)
    for policy, B in (("fifo", 256), ("fifo", 1), ("lru", 1)):
        keep1, sl, va, _ = P.distinct_shard_states_kernel(
            fs, shards=SHARDS, block=B, policy=policy, **DISTINCT)
        ms, mv = P.merge_distinct_states(sl, va)
        new = P.distinct_apply_kernel(fs, keep1, ms, mv, d=d, shards=SHARDS)
        old = torch.empty(m, dtype=torch.bool, device="cuda")
        _, secs = sync_time(lambda: serial_kernel(
            torch, "distinct_apply_scan", [VP] * 5 + [I64] + [I32] * 4
            + [U32, I32, I32], ptr(fs), ptr(keep1), ptr(ms), ptr(mv),
            ptr(old), m, m // SHARDS, d, w, SHARDS * w, 0, 0,
            grid_for(m, fs.device)))
        check(same(new, old), f"distinct_apply after {policy} B={B} differs "
              "from the scan it replaced on the 2^25-entry column")
        say("witness", kernel="distinct_apply", S=SHARDS, policy=policy, B=B,
            entries=m, scan_s=secs, survivors=int(keep1.sum()),
            kept=int(new.sum()), max_abs_err=max_abs_err([(new, old)]))
    witness_topn_apply(torch, xs)
    d, w, D = TOPN["d"], TOPN["w"], pts.shape[1]
    mode = P._score_mode(SKYLINE["score"], "engine")
    for S in (1, SHARDS):
        new = P.topn_shard_states_kernel(xs, shards=S, block=1, **TOPN)
        old = (torch.empty(m, dtype=torch.bool, device="cuda"),
               torch.empty((S, d, w), dtype=torch.float32, device="cuda"))
        _, secs = sync_time(lambda: serial_kernel(
            torch, "topn_pass1_serial", [VP] * 3 + [I32] * 4 + [U32],
            *(ptr(t) for t in (xs,) + old), S, m // S, d, w, 0))
        err = max_abs_err(zip(new, old))
        check(err == 0.0 and all(same_bits(a, b) for a, b in zip(new, old)),
              f"topn_pass1 S={S} B=1 differs from the serial kernel on the "
              "2^25-entry column")
        say("witness", kernel="topn_pass1", S=S, entries=m, serial_s=secs,
            kept=int(new[0].sum()), max_abs_err=err)
        new = P.skyline_shard_states_kernel(pts, shards=S, block=1,
                                            form="engine", **SKYLINE)
        old = (torch.empty(m, dtype=torch.bool, device="cuda"),
               torch.empty((S, SKYLINE["w"], D), dtype=torch.float32,
                           device="cuda"),
               torch.empty((S, SKYLINE["w"]), dtype=torch.float32,
                           device="cuda"))
        _, secs = sync_time(lambda: serial_kernel(
            torch, "skyline_pass1_serial", [VP] * 4 + [I32] * 5,
            *(ptr(t) for t in (pts,) + old), S, m // S, D, SKYLINE["w"],
            mode))
        err = max_abs_err(zip(new, old))
        check(err == 0.0 and all(same_bits(a, b) for a, b in zip(new, old)),
              f"skyline_pass1 S={S} B=1 differs from the serial kernel on "
              "the 2^25-entry column")
        say("witness", kernel="skyline_pass1", S=S, entries=m,
            serial_s=secs, kept=int(new[0].sum()), max_abs_err=err)
    witness_rle_bloom(torch, table, rankings, rle)
    witness_cms_skyline(torch, table, pts)
    witness_queries(torch, table, rankings)


def witness_topn_apply(torch, xs):
    """topn_apply against the apply it replaced (the C entry
    topn_apply_grid, which reads a contiguous copy of the column as the
    engine's family does, without the flush), bit for bit on the whole
    2^25-entry column at S = 128, in the engine's family after B = 1 and
    B = 256 pass 1; the main path's column holds no subnormal and its
    merged minima no non-finite value, where the two families and the
    flush agree, so the kernels' family is held to it too."""
    from repro_torch.kernels import parallel as P
    from repro_torch.kernels.common import (I32, I64, P as VP, U32,
                                            grid_for, ptr)

    m, d = M_MAIN, TOPN["d"]
    for B in (1, 256):
        _, st = P.topn_shard_states_kernel(xs, shards=SHARDS, block=B, **TOPN)
        merged = P.merge_topn_states(st, TOPN["w"])
        rowmin = merged[:, -1].contiguous()
        old = torch.empty(m, dtype=torch.bool, device="cuda")
        _, secs = sync_time(lambda: serial_kernel(
            torch, "topn_apply_grid", [VP] * 3 + [I64, I32, I32, U32, I32],
            ptr(xs), ptr(rowmin), ptr(old), m, m // SHARDS, d, 0,
            grid_for(m, xs.device)))
        for fam in P.FAMILIES:
            new = P.topn_apply_kernel(xs, merged, d=d, shards=SHARDS,
                                      family=fam)
            check(same(new, old), f"topn_apply {fam} after B={B} differs "
                  "from the apply it replaced on the 2^25-entry column")
            say("witness", kernel="topn_apply", family=fam, S=SHARDS, B=B,
                entries=m, grid_s=secs, kept=int(new.sum()),
                max_abs_err=max_abs_err([(new, old)]))


def witness_cms_skyline(torch, table, pts):
    """The partial-table Count-Min build against the atomic build it replaced
    (cms_build_atomic) at its four main-path shapes, and the compacted
    SKYLINE apply against the slot-order scan (skyline_apply_scan) on both
    merged sets, bit for bit over the 2^25 entries."""
    from repro_torch.kernels import cms_sketch as C
    from repro_torch.kernels import parallel as P

    for path, keys, wts, fam, rows_, width, lanes, _ in cms_shapes(table):
        new = C.cms_build_kernel(keys, wts, rows=rows_, width=width,
                                 family=fam, shards=lanes)
        old, secs = sync_time(lambda: cms_atomic(torch, keys, wts, rows_,
                                                 width, fam, lanes))
        err = max_abs_err([(new, old)])
        check(err == 0.0 and same_bits(new, old), f"cms_build {path} "
              "differs from the atomic build it replaced")
        say("witness", kernel="cms_build", path=json.dumps(path),
            lanes=lanes, keys=keys.numel(), atomic_s=secs, max_abs_err=err)
    m = pts.shape[0]
    for name, mp, msc in merged_skyline_sets(torch, P, pts):
        new = P.skyline_apply_kernel(pts, mp, msc)
        old = torch.empty(m, dtype=torch.bool, device="cuda")
        _, secs = sync_time(lambda: skyline_scan(torch, pts, mp, msc, old))
        check(same(new, old), f"skyline_apply on the {name} differs from "
              "the scan it replaced on the 2^25-entry column")
        say("witness", kernel="skyline_apply", merged=json.dumps(name),
            entries=m, k=P.skyline_compact_plain(mp, msc)[0].shape[0],
            scan_s=secs, kept=int(new.sum()),
            max_abs_err=max_abs_err([(new, old)]))


def witness_queries(torch, table, rankings):
    """The persistent Count-Min and Bloom queries against the grid-stride
    queries they replaced (C entries cms_query_grid, bloom_query_grid), bit
    for bit over the whole 2^25-entry column, at every main-path shape:
    ops.cms_query (f32, estimates), HAVING COUNT and SUM and the two-pass
    COUNT on its merged table (fused thresholds); JOIN's keep_a and keep_b
    and ops.bloom_query. The tables and filters are finite, where the
    retired queries are right."""
    from repro_torch import core
    from repro_torch.kernels import bloom_filter as B
    from repro_torch.kernels import cms_sketch as C
    from repro_torch.kernels.common import (F32, I32, I64, P as VP, U32,
                                            grid_for, ptr)

    for path, keys, wts, fam, rows_, width, lanes, thr in cms_shapes(table):
        tb = C.cms_build_kernel(keys, wts, rows=rows_, width=width,
                                family=fam, shards=lanes)
        tq = core.merge_states("having", core.CountMin(tb)).table
        new = C.cms_query_kernel(tq, keys, family=fam, threshold=thr)
        old = torch.empty_like(new)
        ttype = 0 if tq.dtype == torch.float32 else 1
        thr_i = 0 if thr is None or ttype == 0 else C._int_threshold(
            thr, tq.dtype)
        thr_f = 0.0 if thr is None or ttype else float(thr)
        m = keys.numel()
        _, secs = sync_time(lambda: serial_kernel(
            torch, "cms_query_grid", [VP] * 4 + [I64, I32, I32, U32, I32,
                                                  I32, I64, F32, I32],
            ptr(tq), ptr(C._keys_u32(keys)),
            None if thr is not None else ptr(old),
            ptr(old) if thr is not None else None, m, rows_, width, 0,
            C._family(fam, keys), ttype, thr_i, thr_f,
            grid_for(m, keys.device)))
        err = max_abs_err([(new, old)])
        check(err == 0.0 and same_bits(new, old), f"cms_query {path} "
              "differs from the grid-stride query it replaced")
        say("witness", kernel="cms_query", path=json.dumps(path),
            keys=m, grid_s=secs, max_abs_err=err)
    H = JOIN["num_hashes"]
    built = [(B.bloom_build_kernel(k, nbits=nb, num_hashes=H, seed=seed,
                                   family=fam), dict(nbits=nb, num_hashes=H,
                                                     seed=seed, family=fam))
             for _, k, fam, nb, seed in bloom_shapes(table, rankings)]
    (fa, kwa), (fb, kwb), (fo, kwo) = built
    dest, page = table.cols["dest_url"], rankings.cols["page_url"]
    for path, words, keys, kw in (
            ("run_query JOIN keep_a (F_B on dest_url)", fb, dest, kwb),
            ("run_query JOIN keep_b (F_A on page_url)", fa, page, kwa),
            ("ops.bloom_query (dest_url)", fo, dest, kwo)):
        new = B.bloom_query_kernel(words, keys, **kw)
        old = torch.empty_like(new)
        m = keys.numel()
        _, secs = sync_time(lambda: serial_kernel(
            torch, "bloom_query_grid", [VP] * 3 + [I64, U32, I32, U32, I32,
                                                   I32],
            ptr(words), ptr(C._keys_u32(keys)), ptr(old), m, kw["nbits"],
            kw["num_hashes"], kw["seed"] & 0xFFFFFFFF,
            B._family(kw["family"], kw["nbits"], keys),
            grid_for(m, keys.device)))
        err = max_abs_err([(new, old)])
        check(err == 0.0 and same(new, old), f"bloom_query {path} differs "
              "from the grid-stride query it replaced")
        say("witness", kernel="bloom_query", path=json.dumps(path), keys=m,
            positives=int(new.sum()), grid_s=secs, max_abs_err=err)


def witness_rle_bloom(torch, table, rankings, rle):
    """The chunked RLE run scan against rle_topn_det_serial, and the cluster
    Bloom build (by its C entry, whatever the wrapper's route) and the
    wrapper against bloom_build_global, bit for bit at full size."""
    from repro_torch.kernels import bloom_filter as B
    from repro_torch.kernels import rle_scan as RS
    from repro_torch.kernels.common import I32, P as VP, ptr

    rv, rl = rle
    N, w = RLE_TOPN["N"], RLE_TOPN["w"]
    for name, v, L in (("ascending", rv, rl),
                       *rle_pruning_layouts(torch, rv, rl)):
        new = RS.rle_topn_det_kernel(v, L, N=N, w=w)
        old = (torch.empty_like(new[0]), torch.empty_like(new[1]))
        _, secs = sync_time(lambda: serial_kernel(
            torch, "rle_topn_det_serial", [VP] * 4 + [I32] * 3,
            ptr(v), ptr(L), ptr(old[0]), ptr(old[1]), v.numel(), N, w))
        err = max_abs_err(zip(new, old))
        check(err == 0.0 and all(same(a, b) for a, b in zip(new, old)),
              f"rle_topn_det {name} differs from the one-CTA run scan at "
              "2^19 runs")
        say("witness", kernel="rle_topn_det", layout=json.dumps(name),
            runs=v.numel(), serial_s=secs, max_abs_err=err)
    for path, keys, fam, nbits, seed in bloom_shapes(table, rankings)[:2]:
        kw = dict(nbits=nbits, num_hashes=JOIN["num_hashes"], seed=seed,
                  family=fam)
        new = torch.empty(B.num_words(nbits), dtype=torch.uint32,
                          device="cuda")
        bloom_cluster(torch, keys, new, kw)
        old = torch.empty_like(new)
        _, secs = sync_time(lambda: bloom_global(torch, keys, old, kw))
        err = max_abs_err([(new, old)])
        check(err == 0.0 and same(new, old)
              and same(B.bloom_build_kernel(keys, **kw), old),
              f"bloom_build {path}: the cluster build or the wrapper differs "
              "from the global-atomic kernel")
        K = bloom_plan_k(torch, nbits, kw["num_hashes"])
        say("witness", kernel="bloom_build", path=json.dumps(path),
            route=B.bloom_route(nbits, kw["num_hashes"], keys.numel(), K),
            keys=keys.numel(),
            global_s=secs,
            bits_set=int(B.unpack_bits(new, nbits).sum()), max_abs_err=err)


SOURCES = {
    # B = 1: the row-parallel walks (the engine's scan and two_pass)
    "topn_pass1": ("src/repro_torch/kernels/csrc/topn.cu",
                   "src/repro/kernels/topn_prune.py:49, "
                   "src/repro/kernels/parallel.py:86"),
    # topn_pass1 at B > 1 once the lanes fill the card: the staged kernel
    "topn_pass1_block": ("src/repro_torch/kernels/csrc/topn.cu",
                         "src/repro/kernels/parallel.py:86"),
    "topn_apply": ("src/repro_torch/kernels/csrc/topn.cu",
                   "src/repro/kernels/parallel.py:126"),
    "distinct_pass1": ("src/repro_torch/kernels/csrc/distinct.cu",
                       "src/repro/kernels/distinct_prune.py:67, "
                       "src/repro/kernels/parallel.py:209"),
    # distinct_pass1 at B > 1 once the lanes fill the card: the staged kernel
    "distinct_pass1_block": ("src/repro_torch/kernels/csrc/distinct.cu",
                             "src/repro/kernels/parallel.py:209"),
    "distinct_apply": ("src/repro_torch/kernels/csrc/distinct.cu",
                       "src/repro/kernels/parallel.py:267"),
    "skyline_pass1": ("src/repro_torch/kernels/csrc/skyline.cu",
                      "src/repro/kernels/skyline_prune.py:70, "
                      "src/repro/kernels/parallel.py:357"),
    "skyline_apply": ("src/repro_torch/kernels/csrc/skyline.cu",
                      "src/repro/kernels/parallel.py:398"),
    "cms_build": ("src/repro_torch/kernels/csrc/cms.cu",
                  "src/repro/kernels/cms_sketch.py:39"),
    "cms_query": ("src/repro_torch/kernels/csrc/cms.cu",
                  "src/repro/kernels/cms_sketch.py:72"),
    "bloom_build": ("src/repro_torch/kernels/csrc/bloom.cu",
                    "src/repro/kernels/bloom_filter.py:39"),
    "bloom_query": ("src/repro_torch/kernels/csrc/bloom.cu",
                    "src/repro/kernels/bloom_filter.py:71"),
    # bloom_build for filters of 48 KB or less (staged) and filters too
    # large for a cluster
    "bloom_build_global": ("src/repro_torch/kernels/csrc/bloom.cu",
                           "src/repro/kernels/bloom_filter.py:39"),
    # no pallas_call: the lax.scan of core.groupby.groupby_prune
    "groupby_pass1": ("src/repro_torch/kernels/csrc/groupby.cu",
                      "src/repro/core/groupby.py:80"),
    "rle_topn_det": ("src/repro_torch/kernels/csrc/topn_det.cu",
                     "src/repro/kernels/rle_scan.py:98"),
    # no pallas_call: the lax.scans of core.topn.topn_det_prune and of
    # core.distinct.distinct_prune with policy "lru"
    "topn_det_pass1": ("src/repro_torch/kernels/csrc/topn_det.cu",
                       "src/repro/core/topn.py:112"),
    "distinct_pass1_lru": ("src/repro_torch/kernels/csrc/distinct.cu",
                           "src/repro/core/distinct.py:47"),
    # distinct_pass1 at B > 1 while the lanes fill few SMs (use_block_walk)
    "distinct_pass1_block_walk": ("src/repro_torch/kernels/csrc/distinct.cu",
                                  "src/repro/kernels/distinct_prune.py:67"),
    # the same kernel at the token pipeline's B = 16 (phase edges)
    "distinct_pass1_block_walk_b16": (
        "src/repro_torch/kernels/csrc/distinct.cu",
        "src/repro/kernels/distinct_prune.py:67"),
    # topn_pass1 at B > 1 while the lanes fill few SMs (use_block_walk)
    "topn_pass1_block_walk": ("src/repro_torch/kernels/csrc/topn.cu",
                              "src/repro/kernels/topn_prune.py:49"),
    # the kernels' family of TOP-N pass 1: the keep of the one-hot read
    "topn_onehot_fixup": ("src/repro_torch/kernels/csrc/topn.cu",
                          "src/repro/kernels/topn_prune.py:34"),
    # no pallas_call: the vmapped lax.scans of core.batched's bodies
    "topn_pass1_batch": ("src/repro_torch/kernels/csrc/topn.cu",
                         "src/repro/core/batched.py:198"),
    "distinct_pass1_batch": ("src/repro_torch/kernels/csrc/distinct.cu",
                             "src/repro/core/batched.py:255"),
    "distinct_pass1_batch_lru": ("src/repro_torch/kernels/csrc/distinct.cu",
                                 "src/repro/core/batched.py:255"),
    "groupby_pass1_batch": ("src/repro_torch/kernels/csrc/groupby.cu",
                            "src/repro/core/batched.py:394"),
}


def _row(name, totals, err, ms, plain_ms, bound_ms, bound_by):
    """One entry of the kernels line. A serial chain is a bound by
    operations: dependent steps, not bytes."""
    source, replaces = SOURCES[name]
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": totals[name],
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bound_by == "bytes" else "operations",
           "library_ms": None}
    say("timing", **{k: json.dumps(v) for k, v in row.items()})
    return row


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: PyTorch is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import common
        from repro_torch.kernels import ops as O
        from repro_torch.kernels import parallel as P
        from repro_torch.kernels import ref as R
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing: {e}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    say("device", name=json.dumps(torch.cuda.get_device_name(0)),
        torch=torch.__version__, cuda=torch.version.cuda)
    card = card_line()
    clock_hz = max_clock_hz()
    say("device", card=json.dumps(card), max_sm_clock_hz=clock_hz)
    try:
        lib, secs = sync_time(lambda: common.build(verbose=True))
        common.library()
        say("build", library=lib.name, s=round(secs, 3))
    except RuntimeError as e:
        print(f"chip_smoke: kernel build failed: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products add in f32 throughout (no bf16 split-K reduction), as
    # the port's CPU path and the reference do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say("phase", name=name, s=round(time.perf_counter() - t0, 3))
        return out

    # the host-side plain loops of phase timing start now, beside phase
    # kernels; they are stopped however the phases end
    host = HostPlain(torch, P, R)
    try:
        timed("kernels", phase_kernels, torch, P, R, O, host)
        timed("dtypes", phase_dtypes, torch, P)
        say("host", plain_loops_done=host.done())
        table, rankings, pts, totals, encoded, rle, paths, answers = timed(
            "main", phase_main, torch, P, O)
        timed("mesh", phase_mesh, torch, P, table, rankings, answers)
        sbytes = timed("planner", phase_planner, torch, table)
        timed("obs", phase_obs, torch, paths, sbytes)
        timed("stream", phase_stream, torch, P, table, pts)
        batch_rows = timed("batch", phase_batch, torch, P, table, pts,
                           clock_hz, host)
        timed("tune", phase_tune, torch, P, table)
        edge_rows = timed("edges", phase_edges, torch, P, table, clock_hz)
        timed("serve", phase_serve, torch, P, card)
        timed("subnormals", phase_subnormals, torch, P, R, table)
        rows = timed("timing", phase_timing, torch, P, R, table, rankings,
                     pts, totals, clock_hz, encoded, rle, host) \
            + batch_rows + edge_rows
    finally:
        host.close()
    timed("witness", phase_witness, torch, table, rankings, pts, rle)
    say("done", s=round(time.perf_counter() - t_start, 3),
        failures=len(FAILURES))
    if FAILURES:
        print("chip_smoke: failed: " + "; ".join(FAILURES), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
