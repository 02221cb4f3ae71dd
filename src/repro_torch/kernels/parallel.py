"""The two-pass pruning kernels: per-shard pass 1, merge, pass-2 apply.

Pass 1 runs S switch lanes, one per contiguous shard of the stream, each
with block semantics (``ref.py``), and writes every lane's final state. The
merge folds the S states with plain tensor ops (the JAX package leaves it
to XLA as well). Pass 2 applies the merged state to every entry, with no
state carried between entries.

Each kernel entry point takes the CUDA kernel for a CUDA tensor and its
plain version for a CPU tensor; a kernel that fails to build or launch
raises. Keep masks are bool. Fingerprints stay uint32.

The same pass-1 kernel carries four callers of the JAX package: the engine's
scan (S = 1, B = 1), its sharded and two_pass modes (S lanes, B = 1), and
the kernel entry points of ``ops.py`` (B = 256, S = 1 or S shards).
SKYLINE's pass 1 also takes the APH association as ``form``: ``"kernel"``
for ``ops.py`` (the Pallas kernels' score), ``"engine"`` for the engine.
DISTINCT's pass 1 also takes the cache policy: FIFO at any B, LRU at B = 1
only (the engine's default policy; the Pallas kernels are FIFO only). At
B > 1 the pass 1 of TOP-N and of DISTINCT each has two forms on the card,
picked by the shape (``use_block_walk``): the row-parallel block walk and
the one-CTA-a-lane block kernel.
``KERNELS`` lists every CUDA kernel of the port, the Count-Min pair of
``cms_sketch.py``, the Bloom pair of ``bloom_filter.py``, the GROUP BY
scan of ``groupby_scan.py``, the ``topn_det`` ladder of
``topn_det_scan.py``, the RLE run scan of ``rle_scan.py`` and the
query-batched walks of ``batch_walks.py`` included.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..constants import NEG
from ..core.hashing import as_u32, hash_mod
from ..core.skyline import FORMS, SCORES
from . import ref
from .bloom_filter import BLOOM_BUILD, BLOOM_BUILD_GLOBAL, BLOOM_QUERY
from .cms_sketch import CMS_BUILD, CMS_QUERY, onehot_reads, wrap_i32
from .common import (I32, I64, MAX_SMEM, P, U32, CudaKernel, LaunchCount,
                     check_cuda, check_rowpar, grid_for, library_fn, ptr,
                     query_out, sm_count, workspace)
from .common import flush_subnormals as ftz
from .batch_walks import BATCH_KERNELS
from .groupby_scan import GROUPBY_PASS1
from .rle_scan import RLE_TOPN_DET
from .topn_det_scan import TOPN_DET_PASS1

TOPN_PASS1 = CudaKernel("topn_pass1",
                        [P, P, P, I32, I32, I32, I32, I32, U32, P, P, U32,
                         I32], smem_fn="topn_pass1_smem")
TOPN_BLOCK_WALK = CudaKernel("topn_pass1_block_walk",
                             [P, P, P, I32, I32, I32, I32, I32, U32, P, P])
# the kernels' family of TOP-N pass 1: the keep of the Pallas one-hot read
# (ref.onehot_keep), written over the direct read's after pass 1
TOPN_ONEHOT_FIXUP = CudaKernel("topn_onehot_fixup",
                               [P, P, P, I32, I32, I32, I32, I32, U32, I32])
TOPN_APPLY = CudaKernel("topn_apply", [P, P, I64, P, I32, I32, I32, U32,
                                       I32, I32, I32, I32, I32, P, U32])
FAMILIES = ("kernel", "engine")  # topn_apply's reads of the row minimum
DISTINCT_PASS1 = CudaKernel(
    "distinct_pass1",
    [P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, U32, P, I32],
    smem_fn="distinct_pass1_smem")
# the LRU policy of distinct_pass1's row-parallel walk, counted apart
DISTINCT_PASS1_LRU = LaunchCount("distinct_pass1_lru")
# the one-CTA-a-lane block kernels of topn_pass1 and distinct_pass1 (B > 1),
# counted apart from their row-parallel walks (B = 1)
TOPN_PASS1_BLOCK = LaunchCount("topn_pass1_block")
DISTINCT_PASS1_BLOCK = LaunchCount("distinct_pass1_block")
DISTINCT_BLOCK_WALK = CudaKernel(
    "distinct_pass1_block_walk",
    [P, P, P, P, P, I32, I32, I32, I32, I32, I32, U32, P])
DISTINCT_APPLY = CudaKernel(
    "distinct_apply", [P, P, P, P, P, I64, I32, I32, I32, I32, U32, I32,
                       I64, I32, P])
SKYLINE_PASS1 = CudaKernel(
    "skyline_pass1", [P, P, P, P, I32, I32, I32, I32, I32, I32, P, I32],
    smem_fn="skyline_pass1_smem")
SKYLINE_APPLY = CudaKernel("skyline_apply",
                           [P, P, P, P, I64, I32, I32, I32, P])
KERNELS = (TOPN_PASS1, TOPN_APPLY, DISTINCT_PASS1, DISTINCT_APPLY,
           SKYLINE_PASS1, SKYLINE_APPLY, CMS_BUILD, CMS_QUERY, BLOOM_BUILD,
           BLOOM_QUERY, GROUPBY_PASS1, TOPN_DET_PASS1, DISTINCT_PASS1_LRU,
           RLE_TOPN_DET, DISTINCT_BLOCK_WALK, TOPN_BLOCK_WALK,
           BLOOM_BUILD_GLOBAL, TOPN_PASS1_BLOCK, DISTINCT_PASS1_BLOCK,
           TOPN_ONEHOT_FIXUP) + BATCH_KERNELS
POLICIES = ("lru", "fifo")


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _check_shape(m: int, d: int, shards: int, block: int,
                 any_d: bool = False) -> int:
    """``any_d``: the kernels hash with both branches of ``hash_mod``, so
    d may reach 2^16 and above (the Pallas kernels reduce by multiply-shift
    only)."""
    if d < 1:
        raise ValueError(f"a table needs d >= 1 rows, got {d}")
    if d >= (1 << 16) and not any_d:
        raise ValueError("multiply-shift range reduction needs d < 2^16")
    return _check_shards(m, shards, block)


def _check_shards(m: int, shards: int, block: int) -> int:
    if shards < 1 or m % shards:
        raise ValueError(f"stream length {m} is not a multiple of "
                         f"shards={shards}")
    shard_len = m // shards
    if block < 1 or shard_len % block:
        raise ValueError(f"shard length {shard_len} is not a multiple of "
                         f"block={block}; pad the stream")
    return shard_len


def _check_pass1(kernel: CudaKernel, d: int, w: int, block: int) -> None:
    """d is the row count (TOP-N, DISTINCT) or the point width D (SKYLINE)."""
    if block > 1024:
        raise ValueError(f"the CUDA pass-1 kernel takes block <= 1024, "
                         f"got {block}")
    need = kernel.smem_bytes(d, w, block)
    if need > MAX_SMEM:
        raise ValueError(f"{kernel.name} needs {need} bytes of shared memory "
                         f"at d={d}, w={w}, block={block}; a Hopper block has "
                         f"{MAX_SMEM}")


def _check_resume(what: str, block: int, carried: tuple | None,
                  shapes: tuple, dtypes: tuple,
                  device: torch.device) -> None:
    """A carried state resumes the one-entry (B = 1) pass only, the
    reference having no resumed block kernel, and must be stacked [S, ...]
    tensors of the pass's own shapes and dtypes, contiguous, on the
    stream's device (they are written in place)."""
    if carried is None:
        return
    if block != 1:
        raise ValueError(f"{what}: a carried state resumes the one-entry "
                         f"pass only (block=1), got block={block}")
    if len(carried) != len(shapes) or any(
            t.dtype != dt or tuple(t.shape) != sh or t.device != device
            or not t.is_contiguous()
            for t, sh, dt in zip(carried, shapes, dtypes)):
        raise ValueError(f"{what}: a carried state is "
                         + ", ".join(f"{dt} {list(sh)}" for sh, dt in
                                     zip(shapes, dtypes))
                         + f", contiguous on {device}")


def use_block_walk(shards: int, device: torch.device) -> bool:
    """Whether pass 1 at B > 1, of TOP-N and of DISTINCT alike, takes the
    row-parallel block walk on the card (else the staged one-CTA-a-lane
    block kernel): while the lanes fill fewer than one SM in six. The block
    kernel's chain is shard_len / B steps a lane on one SM and needs no
    partition; the walk spreads every lane over the card but partitions the
    stream first. chip_smoke.py's time_block_forms, NVIDIA H100 80GB HBM3 at
    700.00 W, B = 256, on 2^25 entries, walk / block kernel in ms: DISTINCT
    on zipf keys, d=4096, w=4: S=1 4.535 / 52.33, S=8 3.204 / 6.595, S=16
    3.219 / 3.401, S=32 3.122 / 1.707, S=64 3.190 / 0.938, S=128 3.038 /
    0.461; TOP-N on gamma(2, 50) values, d=512, w=8: S=1 2.434 / 34.20,
    S=8 2.078 / 5.232, S=16 2.050 / 2.934, S=32 2.063 / 1.626, S=64 1.988 /
    0.877, S=128 2.040 / 0.496. The block kernel's time goes as 1/S (about
    54 / S ms for DISTINCT, 47 / S for TOP-N) and the walk's stays, so the
    forms cross near S = 17 and S = 23: the threshold sits between, the
    block kernel from 22 lanes on 132 SMs."""
    return 6 * shards < sm_count(device)


# ======================================================= TOP-N (rand, Ex. 7)
def topn_shard_states_kernel(values: torch.Tensor, *, d: int, w: int,
                             shards: int, block: int = 256, seed: int = 0,
                             family: str = "kernel",
                             state: torch.Tensor | None = None,
                             index_offset: int = 0):
    """Pass 1: keep bool[m] and per-shard matrices f32[shards, d, w].

    ``values`` is f32[m], m a multiple of shards * block; lane s owns the
    entries [s * m/S, (s+1) * m/S) and hashes its shard-local index.

    Two families of keep, as for the apply: ``"kernel"`` (the Pallas
    kernels', ``ops.py``) reads each entry's row minimum by the one-hot
    product (``ref.onehot_keep``, ROADMAP Queue 3 A27), ``"engine"`` (the
    engine's scan, two_pass and sharded modes at block=1) reads the minimum
    itself. The matrices are the same in both.

    At block=1 the CUDA path is the row-parallel walk of ``topn.cu``: an
    entry reads and writes only the row its shard-local index hashes to,
    so each (lane, row) is walked on its own, in stream order, after a
    stable partition by index. At block > 1 it is the block walk
    (``topn_block_walk_kernel``) when ``use_block_walk``, else the
    one-CTA-a-lane block kernel. In the kernels' family every form records
    the block of each row's last insert, and ``topn_onehot_fixup`` then
    rewrites the keep of a lane whose matrix holds a row minimum of +inf
    (it returns at once when none does).

    ``state`` [S, d, w] and ``index_offset`` resume the engine's B = 1
    scan (the streaming fold, ``core.topn.topn_rand_prune``): every
    (lane, row) starts from its carried row, which takes the final one in
    place, and the row hashes the shard-local index plus the offset, mod
    2^32. The kernels' family and B > 1 take neither."""
    onehot = _apply_family(family)
    m = values.shape[0]
    shard_len = _check_shape(m, d, shards, block)
    if (state is not None or index_offset) and (block != 1 or onehot):
        raise ValueError("a carried state or an index offset resumes the "
                         "engine's one-entry pass only (block=1, "
                         "family='engine')")
    _check_resume("topn pass 1", block, None if state is None else (state,),
                  ((shards, d, w),), (torch.float32,), values.device)
    index_offset = int(index_offset) & 0xFFFFFFFF
    if not values.is_cuda:
        keep, states = ref.topn_block_ref(
            values.reshape(shards, shard_len), d=d, w=w, block=block,
            seed=seed, return_state=True, onehot=bool(onehot), state=state,
            index_offset=index_offset)
        return keep.reshape(m), states
    if block > 1 and use_block_walk(shards, values.device):
        return topn_block_walk_kernel(values, d=d, w=w, shards=shards,
                                      block=block, seed=seed, family=family)
    check_cuda("values", values, torch.float32)
    if block == 1:
        check_rowpar(m, w, 4)
    else:
        _check_pass1(TOPN_PASS1, d, w, block)
    dev = values.device
    keep = torch.empty(m, dtype=torch.bool, device=dev)
    states = (torch.empty((shards, d, w), dtype=torch.float32, device=dev)
              if state is None else state)
    if m:
        work = (workspace(dev, "topn_pass1_workspace", shards, shard_len, d)
                if block == 1 else None)
        tinf = _tinf(shards, d, dev) if onehot else None
        TOPN_PASS1.launch(dev, ptr(values), ptr(keep), ptr(states), shards,
                          shard_len, d, w, block, seed & 0xFFFFFFFF,
                          None if work is None else ptr(work),
                          None if tinf is None else ptr(tinf), index_offset,
                          int(state is not None),
                          count=TOPN_PASS1_BLOCK if block > 1 else None)
        if onehot:
            topn_onehot_fixup(keep, states, tinf, shards=shards, d=d,
                              block=block, seed=seed)
    elif state is None:
        states.fill_(float(NEG))
    return keep, states


def _tinf(shards: int, d: int, device: torch.device) -> torch.Tensor:
    """[shards * d] 32-bit words (uint32 block ids in int32 storage): the
    block of each row's last insert, which the pass-1 kernels write for
    ``topn_onehot_fixup`` (read only for rows whose final minimum is +inf)."""
    return torch.empty(shards * d, dtype=torch.int32, device=device)


def topn_onehot_fixup(keep: torch.Tensor, states: torch.Tensor,
                      tinf: torch.Tensor, *, shards: int, d: int, block: int,
                      seed: int = 0) -> None:
    """Rewrite pass 1's keep [m] (the direct read's, in place) as the Pallas
    one-hot read's, from the final matrices [S, d, w] and the block of each
    row's last insert (``ref.onehot_keep``). ``csrc/topn.cu``: a grid of
    (CTAs, lanes); each CTA reduces its lane's +inf row minima to (t1, r1,
    t2) and returns at once when there is none, else rewrites its share of
    the entries after block t1."""
    m = keep.shape[0]
    shard_len = m // shards
    w = states.shape[2]
    gx = max(1, min(-(-2 * sm_count(keep.device) // shards),
                    -(-shard_len // 256)))
    TOPN_ONEHOT_FIXUP.launch(keep.device, ptr(keep), ptr(states), ptr(tinf),
                             shards, shard_len, d, w, block,
                             seed & 0xFFFFFFFF, gx)


def topn_block_walk_kernel(values: torch.Tensor, *, d: int, w: int,
                           shards: int, block: int = 256, seed: int = 0,
                           family: str = "kernel"):
    """Pass 1 with block semantics (any block >= 1) by the row-parallel
    block walk of ``topn.cu``: (keep, states) as
    ``topn_shard_states_kernel`` gives them, in the same two families.
    After the partition by (lane, row), one warp walks each row's entries
    in stream order, a block's entries of the row being one group: every
    entry keeps iff its value >= the row's minimum as it stood before its
    group, and the group's candidate (``ref.topn_block_ref``) is inserted
    when it beats that minimum. A CPU tensor runs ``ref.topn_block_ref``."""
    onehot = _apply_family(family)
    m = values.shape[0]
    shard_len = _check_shape(m, d, shards, block)
    if not values.is_cuda:
        keep, states = ref.topn_block_ref(
            values.reshape(shards, shard_len), d=d, w=w, block=block,
            seed=seed, return_state=True, onehot=bool(onehot))
        return keep.reshape(m), states
    check_cuda("values", values, torch.float32)
    check_rowpar(m, w, 4)
    dev = values.device
    keep = torch.empty(m, dtype=torch.bool, device=dev)
    states = torch.empty((shards, d, w), dtype=torch.float32, device=dev)
    if m:
        work = workspace(dev, "topn_pass1_workspace", shards, shard_len, d)
        tinf = _tinf(shards, d, dev) if onehot else None
        TOPN_BLOCK_WALK.launch(dev, ptr(values), ptr(keep), ptr(states),
                               shards, shard_len, d, w, block,
                               seed & 0xFFFFFFFF, ptr(work),
                               None if tinf is None else ptr(tinf))
        if onehot:
            topn_onehot_fixup(keep, states, tinf, shards=shards, d=d,
                              block=block, seed=seed)
    else:
        states.fill_(float(NEG))
    return keep, states


def merge_topn_states(states: torch.Tensor, w: int) -> torch.Tensor:
    """[S, d, w] shard matrices -> [d, w] per-row top-w of the union, as
    the reference's stable sort (``-jnp.sort(-cols)``) orders it: its
    compares flush f32 subnormals (A25), so the values that compare equal
    keep their column order, and every value keeps its bits."""
    S, d, _ = states.shape
    cols = states.movedim(0, 1).reshape(d, -1)
    order = torch.sort(ftz(cols), dim=1, descending=True,
                       stable=True).indices[:, :w]
    return cols.gather(1, order)


def topn_apply_plain(values: torch.Tensor, rowmin: torch.Tensor, *, d: int,
                     shards: int, seed: int = 0, family: str = "kernel",
                     index_offset: int = 0) -> torch.Tensor:
    """Plain pass 2: keep = x >= read(rowmin, hash(shard-local index +
    index_offset, mod 2^32)), compared with f32 subnormals flushed (A25).
    ``read`` is the family's (``topn_apply_kernel``)."""
    m = values.shape[0]
    idx = ((torch.arange(m // shards, device=values.device)
            + int(index_offset)) & 0xFFFFFFFF)
    rows = hash_mod(idx, d, seed)
    if _apply_family(family):
        got = onehot_reads(rowmin.to(torch.float32)[None], rows[:, None])[:, 0]
    else:
        got = rowmin[rows]
    return (ftz(values.reshape(shards, -1)) >= ftz(got)).reshape(m)


def _apply_family(family: str) -> int:
    """The C family of the TOP-N apply and pass 1's keep: 1 the kernels',
    0 the engine's."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    return int(family == "kernel")


@lru_cache(maxsize=None)
def apply_plan(device: torch.device, shards: int, shard_len: int, d: int,
               aligned: bool) -> tuple[int, int, int]:
    """(CTAs over the shard-local quads, shard groups, dynamic shared
    memory) of the CUDA apply on ``device``, as ``csrc/topn.cu`` plans it
    (``topn_apply_plan``: one wave of resident CTAs), asked once a device
    and shape."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = library_fn("topn_apply_plan",
                         [I32, I32, I32, I32, ctypes.POINTER(ctypes.c_int)],
                         I32)(shards, shard_len, d, int(aligned), out)
    if err:
        raise RuntimeError(f"topn_apply_plan failed: cudaError {err}")
    return tuple(int(v) for v in out)


def topn_apply_kernel(values: torch.Tensor, merged: torch.Tensor, *, d: int,
                      shards: int, seed: int = 0, family: str = "kernel",
                      index_offset: int = 0) -> torch.Tensor:
    """Pass 2: keep bool[m] = value >= the read of its row's merged minimum
    (column w - 1 of ``merged`` [d, w]), compared with f32 subnormals
    flushed. Two families (A26): ``"kernel"`` for ``ops.topn_prune_parallel``
    reads as the Pallas kernel's one-hot product does (``onehot_reads``: NaN
    when another row's minimum is not finite or its own is NaN, B15), and
    ``"engine"`` for the engine's two_pass reads the minimum itself, as its
    ``jnp`` body does.

    On the card (``csrc/topn.cu``, ``topn_apply``) a thread hashes 4
    consecutive shard-local indices once and walks its group of the S shards
    with one 16-byte load and one 4-byte store each; the column is read in
    place (no copy) and the keep mask is allocated at the values' offset mod
    16 (``common.query_out``). ``index_offset`` is added to the shard-local
    index before it is hashed, mod 2^32, as the engine's apply of one
    streamed micro-batch hashes it."""
    fam = _apply_family(family)
    m = values.shape[0]
    shard_len = _check_shape(m, d, shards, 1)
    if merged.ndim != 2 or merged.shape[0] != d or merged.shape[1] < 1:
        raise ValueError(f"merged must be [d={d}, w], got {tuple(merged.shape)}")
    index_offset = int(index_offset) & 0xFFFFFFFF
    if not values.is_cuda:
        return topn_apply_plain(values, merged[:, -1], d=d, shards=shards,
                                seed=seed, family=family,
                                index_offset=index_offset)
    check_cuda("values", values, torch.float32)
    if not merged.is_cuda or merged.device != values.device \
            or merged.dtype != torch.float32:
        raise ValueError("merged must be a float32 CUDA tensor on the "
                         "values' device")
    dev = values.device
    keep = query_out(values, m, torch.bool)
    if m:
        aligned = shard_len % 4 == 0 and values.data_ptr() % 16 == 0
        gx, groups, smem = apply_plan(dev, shards, shard_len, d, aligned)
        work = (None if smem else
                torch.empty(1, dtype=torch.int32, device=dev))
        col = merged.data_ptr() + (merged.shape[1] - 1) * merged.stride(1) * 4
        TOPN_APPLY.launch(dev, ptr(values), col, merged.stride(0), ptr(keep),
                          shards, shard_len, d, seed & 0xFFFFFFFF, fam,
                          int(aligned), gx, groups, smem,
                          None if work is None else ptr(work), index_offset)
    return keep


def topn_parallel_ref(values, *, d, w, shards, block, seed=0):
    """Plain pass 1 + merge + pass 2: the mirror of the two-pass kernels."""
    _, states = ref.topn_block_ref(values.reshape(shards, -1), d=d, w=w,
                                   block=block, seed=seed, return_state=True)
    merged = merge_topn_states(states, w)
    keep = topn_apply_plain(values, merged[:, -1], d=d, shards=shards,
                            seed=seed)
    return keep, states


# ============================================== DISTINCT (FIFO / LRU, Ex. 2)
def distinct_form(values: torch.Tensor) -> torch.Tensor:
    """A stream as the DISTINCT kernels take it: float32 for a float stream
    (``ref.distinct_keys``: hashed by its bits, compared as the JAX package
    compares an f32 value with a uint32 slot), else its 32-bit lanes as
    uint32 (an int32 stream by its bits, as the JAX package compares it)."""
    if values.dtype in (torch.uint32, torch.float32):
        return values.contiguous()
    if values.is_floating_point():
        return values.to(torch.float32).contiguous()
    return wrap_i32(as_u32(values)).view(torch.uint32)


def _check_distinct_dtype(values: torch.Tensor) -> None:
    if values.dtype not in (torch.uint32, torch.float32):
        raise TypeError(f"values must be uint32 or float32 (see "
                        f"distinct_form), got {values.dtype}")


def _distinct_outputs(shards: int, d: int, w: int, m: int, device):
    """Pass-1 outputs for a kernel to fill: keep bool[m], slots
    uint32[S, d, w], valid bool[S, d, w], head int32[S, d]; the states of
    an empty stream (m = 0) are zeros."""
    out = (torch.empty(m, dtype=torch.bool, device=device),
           torch.empty((shards, d, w), dtype=torch.uint32, device=device),
           torch.empty((shards, d, w), dtype=torch.bool, device=device),
           torch.empty((shards, d), dtype=torch.int32, device=device))
    if not m:
        out[1].view(torch.int32).zero_()
        out[2].zero_()
        out[3].zero_()
    return out


def distinct_shard_states_kernel(values: torch.Tensor, *, d: int, w: int,
                                 shards: int, block: int = 256,
                                 seed: int = 0, policy: str = "fifo",
                                 state: tuple | None = None):
    """Pass 1: keep bool[m] and per-shard caches (slots uint32[S, d, w],
    valid bool[S, d, w], head int32[S, d]). ``policy="lru"`` takes
    block=1 only (head then stays 0). ``values`` is uint32 or float32
    (``distinct_form``).

    At block=1 the CUDA path is the row-parallel walk of ``distinct.cu``:
    an entry reads and writes only the row its key hashes to, so each
    (lane, row) is walked on its own, in stream order, after a stable
    partition; at d >= 2^16 it hashes by modulo, as ``hash_mod`` does. At
    block > 1 it is the block walk (``distinct_block_walk_kernel``) when
    ``use_block_walk``, else the one-CTA-a-lane block kernel.

    ``state`` (slots, valid, head), stacked [S, ...], resumes the B = 1
    walk (the streaming fold, ``core.distinct.distinct_prune``): every row
    starts from its carried slots, valid flags and FIFO head, which take
    the final ones in place (LRU leaves head as it was)."""
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    if policy == "lru" and block != 1:
        raise ValueError(f"the LRU cache has per-entry semantics only: it "
                         f"takes block=1, got block={block}")
    m = values.shape[0]
    shard_len = _check_shape(m, d, shards, block, any_d=block == 1)
    if w < 1:
        raise ValueError(f"a cache needs w >= 1, got {w}")
    _check_resume("distinct pass 1", block, state,
                  ((shards, d, w), (shards, d, w), (shards, d)),
                  (torch.uint32, torch.bool, torch.int32), values.device)
    if not values.is_cuda:
        lanes = values.reshape(shards, shard_len)
        keep, st = (
            ref.distinct_lru_ref(lanes, d=d, w=w, seed=seed,
                                 return_state=True, state=state)
            if policy == "lru"
            else ref.distinct_block_ref(lanes, d=d, w=w, block=block,
                                        seed=seed, return_state=True,
                                        state=state))
        return (keep.reshape(m),) + st
    if block > 1 and use_block_walk(shards, values.device):
        return distinct_block_walk_kernel(values, d=d, w=w, shards=shards,
                                          block=block, seed=seed)
    _check_distinct_dtype(values)
    check_cuda("values", values, values.dtype)
    if block == 1:
        check_rowpar(m, w, 5)
    else:
        _check_pass1(DISTINCT_PASS1, d, w, block)
    dev = values.device
    out = (_distinct_outputs(shards, d, w, m, dev) if state is None
           else (torch.empty(m, dtype=torch.bool, device=dev),) + tuple(state))
    if not m:
        return out
    lru = policy == "lru"
    work = (workspace(dev, "distinct_pass1_workspace", shards, shard_len, d)
            if block == 1 else None)
    DISTINCT_PASS1.launch(dev, ptr(values), *(ptr(t) for t in out), shards,
                          shard_len, d, w, block, int(lru),
                          int(values.dtype == torch.float32),
                          seed & 0xFFFFFFFF, None if work is None else ptr(work),
                          int(state is not None),
                          count=DISTINCT_PASS1_LRU if lru
                          else DISTINCT_PASS1_BLOCK if block > 1 else None)
    return out


def distinct_block_walk_kernel(values: torch.Tensor, *, d: int, w: int,
                               shards: int, block: int = 256, seed: int = 0):
    """Pass 1 with block semantics (FIFO, any block >= 1) by the
    row-parallel block walk of ``distinct.cu``: (keep, slots, valid, head)
    as ``distinct_shard_states_kernel`` gives them. After the partition by
    (lane, row), one warp walks each row's entries in stream order; an
    entry is probed against the row as it stood before its block, and of
    each (row, block) only the first miss inserts. A CPU tensor runs
    ``ref.distinct_block_ref``."""
    m = values.shape[0]
    shard_len = _check_shape(m, d, shards, block, any_d=block == 1)
    if w < 1:
        raise ValueError(f"a cache needs w >= 1, got {w}")
    if not values.is_cuda:
        keep, state = ref.distinct_block_ref(
            values.reshape(shards, shard_len), d=d, w=w, block=block,
            seed=seed, return_state=True)
        return (keep.reshape(m),) + state
    _check_distinct_dtype(values)
    check_cuda("values", values, values.dtype)
    check_rowpar(m, w, 5)
    dev = values.device
    out = _distinct_outputs(shards, d, w, m, dev)
    if not m:
        return out
    work = workspace(dev, "distinct_pass1_workspace", shards, shard_len, d)
    DISTINCT_BLOCK_WALK.launch(dev, ptr(values), *(ptr(t) for t in out),
                               shards, shard_len, d, w, block,
                               int(values.dtype == torch.float32),
                               seed & 0xFFFFFFFF, ptr(work))
    return out


def cols_by_shard(stacked: torch.Tensor) -> torch.Tensor:
    """[S, d, w] per-shard row state -> [d, S*w] cache-column union
    (column s*w + j is slot j of shard s)."""
    S, d, w = stacked.shape
    if stacked.dtype == torch.uint32:
        return cols_by_shard(stacked.view(torch.int32)).view(torch.uint32)
    return stacked.movedim(0, 1).reshape(d, S * w)


def merge_distinct_states(slots: torch.Tensor, valid: torch.Tensor):
    """[S, d, w] shard caches -> the [d, S*w] union of slots and valid flags.

    The column order carries each slot's owner shard (``cols_by_shard``),
    which pass 2 needs to ask "cached by a lower-ranked shard?"."""
    return cols_by_shard(slots), cols_by_shard(valid)


def distinct_apply_plain(values: torch.Tensor, keep1: torch.Tensor,
                         mslots: torch.Tensor, mvalid: torch.Tensor, *,
                         d: int, shards: int, seed: int = 0, lane0: int = 0,
                         w: int | None = None) -> torch.Tensor:
    """Plain pass 2: drop a pass-1 survivor whose fingerprint is valid in the
    cache of a lower-ranked shard. ``values`` holds ``shards`` lanes, lane s
    being lane ``lane0 + s`` of the union (w columns a lane; default: the
    union is these lanes'). Loops over the owner lanes to bound memory."""
    m = values.shape[0]
    w = mslots.shape[1] // shards if w is None else w
    v = values.reshape(shards, -1)
    x, hittable = ref.distinct_keys(v)
    rows = hash_mod(v, d, seed)
    ms = as_u32(mslots)
    dup = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for o in range(lane0 + shards - 1):
        lo = max(0, o + 1 - lane0)   # the local lanes ranked above owner o
        cols = slice(o * w, (o + 1) * w)
        r, xs = rows[lo:], x[lo:, :, None]
        dup[lo:] |= ((ms[r, cols] == xs) & mvalid[r, cols]).any(-1)
    return keep1 & ~(dup & hittable).reshape(m)


def distinct_apply_kernel(values: torch.Tensor, keep1: torch.Tensor,
                          mslots: torch.Tensor, mvalid: torch.Tensor, *,
                          d: int, shards: int, seed: int = 0, lane0: int = 0,
                          w: int | None = None) -> torch.Tensor:
    """Pass 2: keep bool[m] = keep1 and not cached by a lower-ranked shard.

    ``values`` holds ``shards`` lanes; lane s is lane ``lane0 + s`` of the
    [d, S*w] union (a mesh position applies against its own lanes), w its
    columns a lane (default: S is ``shards``, the union is these lanes').
    On the card ``distinct.cu`` first reduces each row of the union to a
    table from key to the lowest shard that holds it in a valid slot; a
    pass-1 survivor of lane s that can hit is then dropped iff that owner
    is below lane0 + s: one lookup an entry."""
    m = values.shape[0]
    shard_len = _check_shape(m, d, shards, 1, any_d=True)
    sw = mslots.shape[-1]
    whole = w is None
    w = sw // shards if whole else w
    if (mslots.shape != (d, sw) or mvalid.shape != (d, sw) or w < 1
            or sw % (shards if whole else w) or lane0 < 0
            or lane0 + shards > sw // w or keep1.shape != (m,)):
        raise ValueError(
            f"distinct apply takes keep1 [m={m}] and a [d={d}, S*w] union "
            f"holding lanes [lane0={lane0}, {lane0 + shards}) of w={w} "
            f"columns; got keep1 {tuple(keep1.shape)}, "
            f"slots {tuple(mslots.shape)}, valid {tuple(mvalid.shape)}")
    if not values.is_cuda:
        return distinct_apply_plain(values, keep1, mslots, mvalid, d=d,
                                    shards=shards, seed=seed, lane0=lane0,
                                    w=w)
    _check_distinct_dtype(values)
    check_cuda("values", values, values.dtype)
    check_cuda("keep1", keep1, torch.bool, values.device)
    check_cuda("mslots", mslots, torch.uint32, values.device)
    check_cuda("mvalid", mvalid, torch.bool, values.device)
    dev = values.device
    keep = torch.empty(m, dtype=torch.bool, device=dev)
    if m:
        table = workspace(dev, "distinct_apply_workspace", d, sw)
        DISTINCT_APPLY.launch(dev, ptr(values), ptr(keep1), ptr(mslots),
                              ptr(mvalid), ptr(keep), m, shard_len, d,
                              w, sw, seed & 0xFFFFFFFF,
                              int(values.dtype == torch.float32), lane0,
                              grid_for(m, dev), ptr(table))
    return keep


def distinct_parallel_ref(values, *, d, w, shards, block, seed=0):
    """Plain pass 1 + merge + pass 2: the mirror of the two-pass kernels."""
    keep1, state = ref.distinct_block_ref(
        values.reshape(shards, -1), d=d, w=w, block=block, seed=seed,
        return_state=True)
    slots, valid, _ = state
    mslots, mvalid = merge_distinct_states(slots, valid)
    keep = distinct_apply_plain(values, keep1.reshape(-1), mslots, mvalid,
                                d=d, shards=shards, seed=seed)
    return keep, (slots, valid)


# ======================================================== SKYLINE (Ex. 6)
SKYLINE_MAX_D = 8  # the apply kernel is instantiated for D = 1..8


def _score_mode(score: str, form: str) -> int:
    if score not in SCORES or form not in FORMS:
        raise ValueError(f"score must be one of {SCORES} and form one of "
                         f"{FORMS}, got {score!r}, {form!r}")
    return 0 if score == "sum" else 1 + FORMS.index(form)


def _check_points(name: str, points: torch.Tensor) -> int:
    if points.ndim != 2 or points.shape[1] < 1:
        raise ValueError(f"{name} must be [m, D], got {tuple(points.shape)}")
    return points.shape[1]


def skyline_shard_states_kernel(points: torch.Tensor, *, w: int, shards: int,
                                block: int = 256, score: str = "aph",
                                form: str = "kernel",
                                state: tuple | None = None):
    """Pass 1: keep bool[m], stored points f32[S, w, D] and scores f32[S, w].

    ``points`` is f32[m, D], m a multiple of shards * block; lane s owns the
    rows [s * m/S, (s+1) * m/S).

    The CUDA path runs in the phases of ``skyline.cu``: the top-w
    candidates of each chunk of a lane, one chain of store merges a lane,
    then every chunk's keep decisions from its start store (at block=1 the
    engine step, replayed against the exact store; a lane's chunks from its
    first NaN score on are replayed in order).

    ``state`` (points [S, w, D], scores [S, w]) resumes the B = 1 scan (the
    streaming fold, ``core.skyline.skyline_prune``): each lane's chain of
    merges starts from its carried store, which takes the final one in
    place; a carried store that holds a NaN score or is not sorted
    descending is replayed from the lane's first entry in order."""
    D = _check_points("points", points)
    m = points.shape[0]
    shard_len = _check_shards(m, shards, block)
    mode = _score_mode(score, form)
    if w < 1:
        raise ValueError(f"the store needs w >= 1 points, got {w}")
    _check_resume("skyline pass 1", block, state, ((shards, w, D), (shards, w)),
                  (torch.float32, torch.float32), points.device)
    if not points.is_cuda:
        keep, (pts, scs) = ref.skyline_block_ref(
            points.reshape(shards, shard_len, D), w=w, block=block,
            score=score, form=form, return_state=True, state=state)
        return keep.reshape(m), pts, scs
    check_cuda("points", points, torch.float32)
    _check_pass1(SKYLINE_PASS1, D, w, block)
    dev = points.device
    keep = torch.empty(m, dtype=torch.bool, device=dev)
    if state is None:
        pts = torch.zeros((shards, w, D), dtype=torch.float32, device=dev)
        scs = torch.full((shards, w), float(NEG), dtype=torch.float32,
                         device=dev)
    else:
        pts, scs = state
    if m:
        work = workspace(dev, "skyline_pass1_workspace", shards, shard_len,
                         D, w, block)
        SKYLINE_PASS1.launch(dev, ptr(points), ptr(keep), ptr(pts), ptr(scs),
                             shards, shard_len, D, w, block, mode, ptr(work),
                             int(state is not None))
    return keep, pts, scs


def merge_skyline_states(points: torch.Tensor, scores: torch.Tensor):
    """[S, w, D] + [S, w] shard stores -> the [S*w, D] + [S*w] union."""
    S, w, D = points.shape
    return points.reshape(S * w, D), scores.reshape(S * w)


def skyline_apply_plain(points: torch.Tensor, mpoints: torch.Tensor,
                        mscores: torch.Tensor) -> torch.Tensor:
    """Plain pass 2: keep iff no merged point with score > NEG dominates
    the entry. Loops over blocks of entries to bound memory."""
    m, D = points.shape
    x = ftz(points.to(torch.float32))
    mpoints = ftz(mpoints)
    valid = mscores > NEG
    keep = torch.empty(m, dtype=torch.bool, device=points.device)
    step = max(1, (1 << 24) // max(1, mpoints.shape[0] * D))
    for i in range(0, m, step):
        xc = x[i:i + step, None, :]
        dom = ((xc <= mpoints[None]).all(-1) & (xc < mpoints[None]).any(-1)
               & valid[None])
        keep[i:i + step] = ~dom.any(-1)
    return keep


def skyline_compact_plain(mpoints: torch.Tensor, mscores: torch.Tensor):
    """The compacted merged set that ``csrc/skyline.cu``'s apply tests
    against: (points f32[k, D], scores f32[k]). It keeps the valid points
    (score > NEG, no NaN coordinate) that no other valid point dominates,
    one of each group of equal points (the lowest index), ordered by score
    descending, ties to the lowest index. ``skyline_apply_plain`` against
    it gives the mask it gives against the whole set (the argument is in
    the kernel's comment)."""
    p = mpoints.to(torch.float32)
    valid = (mscores > NEG) & ~p.isnan().any(-1)
    pf = ftz(p)                                  # compares flush (A25)
    a, b = pf[:, None, :], pf[None, :, :]        # a = dominator i, b = j
    dom = (b <= a).all(-1) & (b < a).any(-1)
    idx = torch.arange(p.shape[0], device=p.device)
    equal_lower = (a == b).all(-1) & (idx[:, None] < idx[None, :])
    beaten = ((dom | equal_lower) & valid[:, None]).any(0)
    kept = torch.nonzero(valid & ~beaten).flatten()
    order = torch.sort(-ftz(mscores[kept]), stable=True).indices
    kept = kept[order]
    return p[kept], mscores[kept]


def skyline_apply_kernel(points: torch.Tensor, mpoints: torch.Tensor,
                         mscores: torch.Tensor) -> torch.Tensor:
    """Pass 2: keep bool[m] iff no merged stored point dominates the entry.
    On the card: a compaction of the merged set, then the apply against
    the k points kept (``skyline_compact_plain``; one launch of the C
    entry)."""
    D = _check_points("points", points)
    m = points.shape[0]
    sw = mscores.shape[0]
    if mpoints.shape != (sw, D) or mscores.ndim != 1:
        raise ValueError(
            f"skyline apply takes a merged [S*w, D={D}] + [S*w] set; got "
            f"{tuple(mpoints.shape)} and {tuple(mscores.shape)}")
    if not points.is_cuda:
        return skyline_apply_plain(points, mpoints, mscores)
    check_cuda("points", points, torch.float32)
    check_cuda("mpoints", mpoints, torch.float32, points.device)
    check_cuda("mscores", mscores, torch.float32, points.device)
    if D > SKYLINE_MAX_D:
        raise ValueError(f"the CUDA skyline apply takes D <= {SKYLINE_MAX_D}, "
                         f"got {D}")
    keep = torch.empty(m, dtype=torch.bool, device=points.device)
    if m and sw:
        work = workspace(points.device, "skyline_apply_workspace", sw, D)
        SKYLINE_APPLY.launch(points.device, ptr(points), ptr(mpoints),
                             ptr(mscores), ptr(keep), m, D, sw,
                             grid_for(m, points.device), ptr(work))
    elif m:
        keep.fill_(True)
    return keep

