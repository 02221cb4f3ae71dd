"""Count-Min sketch build and query (paper Ex. 5, HAVING): CUDA kernels and
their plain versions.

``cms_build_kernel`` replaces ``cms_build_kernel`` of the JAX package
(``kernels/cms_sketch.py:39``) and ``cms_query_kernel`` its
``cms_query_kernel`` (``:72``); both also carry the engine's HAVING sketch
(``core.sketches``). Two hash families: ``"kernel"`` is the Pallas kernels'
``hash_mod(key, width, seed + 101 r)``, ``"engine"`` the engine's
``multi_hash(key, width, rows, seed)``. The Pallas kernels hash in the key's
own dtype, so the kernel family hashes an int32 key in signed arithmetic
(``core.hashing``, ``signed=True``; the C family 2), and drops its probes
of -1; every other key by its 32-bit lanes.

The table takes the weights' dtype, as the reference's does: int32 (unit
weights when ``weights`` is None, as COUNT has; integer SUM), which wraps
mod 2^32; uint32, int16, int8, uint16 and uint8, which wrap mod 2^32, 2^16
or 2^8 (built as int32 and wrapped into the dtype); float32; float16, which
adds in f16 in entry order, as XLA's scatter-add does, on the card as in
the plain build (the CUDA build walks each counter's entries in order, so
3000 unit weights on one key read 2048 in both). Keys are 32-bit lanes
(uint32, int32, or float32 hashed by its bits).

Each entry point launches the CUDA kernel for a CUDA tensor and runs the
plain version for a CPU tensor. Integer tables are exact in any order; f32
tables equal the plain sequential sums for integer-valued weights whose
sums stay below 2^24 (``csrc/cms.cu`` says what a non-integer weight gives).

The CUDA build (``csrc/cms.cu``) builds each lane with a few persistent
CTAs whose partial tables, in shared memory, are written with plain stores
and summed in a fixed order by a second kernel; an f32 table adds its
integer-valued weights into an int32 shadow partial, since an f32 shared
add is a compare-and-swap loop on Hopper. The layout is the C side's
alone; ``build_plan`` asks it. ``cms_build_atomic`` is the kernel it
replaced, kept for ``chip_smoke.py``'s witness. A float16 table takes a
kernel of its own, a walk (``cms_build_walk`` in f16: each (row, lane) on
one CTA, each chunk of keys sorted by column in shared memory, each
column's run added in entry order), since f16 adds do not associate. An
f32 build whose weights take both signs is rebuilt after the partial build
(which flags the signs), since its flushed sums do not associate either:
in the engine's family by the same walk in f32, in entry order (ROADMAP
Queue 3 A28; ``_f32_sums``), in the kernels' family by blocks of the
Pallas build, each summed in XLA's reduction order (A29,
``pallas_f32_build``; ``cms_build_blocks`` on the card).

The CUDA query (``cms_query``) is persistent: as many CTAs as the SMs
hold, each with the table staged in its shared memory (a table above the
budget is gathered from global memory), 8 keys a thread a step by 16-byte
loads and one vector store a unit of 4 keys (the output is allocated at
the keys' offset mod 16, ``common.query_out``). ``query_plan`` asks the C
side for the route and the grid once a device and shape. A float table is
read as the reference reads it (``cms_query_plain``): the kernels' family
as the Pallas query's one-hot product, capped at float32(3.4e38); the
engine's as ``jnp.min``. ``cms_query_grid`` is the query it replaced, kept
for ``chip_smoke.py``'s witness.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch

from ..constants import POS
from ..core.hashing import hash_mod, multi_hash
from .common import (F32, FLT_MIN, I32, I64, P, U32, CudaKernel, check_cuda,
                     flush_subnormals, ftz_add, library_fn, ptr, query_out)

CMS_BUILD = CudaKernel("cms_build", [P, P, P, P, I32, I64, I32, I32, U32,
                                     I32, I32, I32])
CMS_QUERY = CudaKernel(
    "cms_query", [P, P, P, P, I64, I32, I32, U32, I32, I32, I64, F32, I32, P])
FAMILIES = ("kernel", "engine")
INT_TABLES = (torch.int32, torch.uint32, torch.int16, torch.int8,
              torch.uint16, torch.uint8)
DTYPES = INT_TABLES + (torch.float32, torch.float16)
_I64_MAX = (1 << 63) - 1
MAX_SMEM = 232448  # a table staged in one CTA's shared memory (227 KB)
# the C build's table dtype by its ttype: f32, int32, f16
_C_TABLES = (torch.float32, torch.int32, torch.float16)


def _family(family: str, keys: torch.Tensor | None = None) -> int:
    """The C hash family: 0 the kernels' on 32-bit lanes, 1 the engine's, 2
    the kernels' on an int32 key (signed arithmetic)."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    if family == "engine":
        return 1
    return 2 if keys is not None and keys.dtype == torch.int32 else 0


def _keys_u32(keys: torch.Tensor) -> torch.Tensor:
    """The keys' 32-bit lanes as a uint32 view (no copy)."""
    if keys.dtype == torch.uint32:
        return keys
    if keys.dtype in (torch.int32, torch.float32):
        return keys.view(torch.uint32)
    raise TypeError(f"keys must be a 32-bit dtype, got {keys.dtype}")


def row_hashes(keys: torch.Tensor, rows: int, width: int, seed: int,
               family: str) -> torch.Tensor:
    """int64 [m, rows]: the counter column of each key in each row (-1: the
    probe is dropped, which only the kernels' family gives an int32 key)."""
    if _family(family) == 1:
        return multi_hash(keys, width, rows, seed)
    signed = keys.dtype == torch.int32
    return torch.stack([hash_mod(keys, width, (seed + 101 * r) & 0xFFFFFFFF,
                                 signed=signed) for r in range(rows)], -1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 mod 2^32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def wrap_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Integers (int64 or int32) wrapped into the integer ``dtype``, mod
    2^bits, as an integer scatter-add of that dtype wraps."""
    if dtype == torch.uint32:
        return wrap_i32(x.to(torch.int64)).view(torch.uint32)
    if dtype == torch.int32:
        return wrap_i32(x.to(torch.int64))
    bits = torch.iinfo(dtype).bits
    x = x.to(torch.int64) & ((1 << bits) - 1)
    if dtype.is_signed:
        x = torch.where(x >= (1 << (bits - 1)), x - (1 << bits), x)
    return x.to(dtype)


def by_value_i64(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor by value in int64 (uint32 by its value)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return x.to(torch.int64)


def cms_build_plain(keys: torch.Tensor, weights: torch.Tensor | None, *,
                    rows: int, width: int, seed: int = 0,
                    family: str = "kernel", shards: int = 1,
                    block: int = 256) -> torch.Tensor:
    """Plain build: [shards, rows, width] tables, lane s over keys
    [s * m/S, (s+1) * m/S). One index_add over all lanes and rows; an f32
    table of the kernels' family sums as the Pallas build does, by blocks of
    ``block`` keys (``pallas_f32_build``)."""
    m = keys.shape[0]
    dev = keys.device
    dtype = torch.int32 if weights is None else weights.dtype
    lane = torch.arange(shards, device=dev).repeat_interleave(m // shards)
    col = row_hashes(keys, rows, width, seed, family)
    hit = (col >= 0).reshape(-1)
    cell = ((lane[:, None] * rows + torch.arange(rows, device=dev)) * width
            + col).reshape(-1)[hit]
    size = shards * rows * width
    if dtype in INT_TABLES:
        w = (torch.ones(m, dtype=torch.int64, device=dev) if weights is None
             else by_value_i64(weights))
        acc = torch.zeros(size, dtype=torch.int64, device=dev)
        acc.index_add_(0, cell, w.repeat_interleave(rows)[hit])
        table = wrap_to(acc, dtype)
    elif dtype == torch.float32 and _family(family) != 1:
        return pallas_f32_build(keys, weights, rows=rows, width=width,
                                seed=seed, family=family, shards=shards,
                                block=block)
    elif dtype == torch.float32:
        table = _f32_sums(cell, flush_subnormals(weights).repeat_interleave(
            rows)[hit], size)
    else:
        table = torch.zeros(size, dtype=dtype, device=dev)
        table.index_add_(0, cell, weights.repeat_interleave(rows)[hit])
    return table.reshape(shards, rows, width)


def _f32_sums(cell: torch.Tensor, w: torch.Tensor, size: int) -> torch.Tensor:
    """f32 counters of the flushed weights ``w`` added into cells ``cell``
    (in entry order), as XLA's scatter-add adds them: in entry order, each
    sum flushed when it is subnormal (A25). A cell whose weights take one
    sign never holds a subnormal sum (a sum of normals of one sign is at
    least each of them), so one ``index_add_`` gives it. A cell that takes
    both signs can pass below FLT_MIN (ROADMAP Queue 3 A28: [1.5, -1, 1] *
    FLT_MIN on one key reads FLT_MIN, not 1.5 * FLT_MIN), so its weights
    are added one at a time in entry order, a flush after each: round k
    adds the k-th weight of every such cell. A sum flushed below zero
    stays -0 here; ``core.sketches.plus_zero_rows`` adds the rows of the
    table to +0 as the reference does (every row eagerly, from row 2 on in
    a jitted body, ROADMAP Queue 3 A29)."""
    dev = cell.device
    table = torch.zeros(size, dtype=torch.float32, device=dev)
    pos = torch.zeros(size, dtype=torch.bool, device=dev)
    neg = torch.zeros(size, dtype=torch.bool, device=dev)
    pos[cell[w > 0]] = True
    neg[cell[w < 0]] = True
    mixed = (pos & neg)[cell]
    table.index_add_(0, cell[~mixed], w[~mixed])
    if bool(mixed.any()):
        mc, mw = cell[mixed], w[mixed]
        order = torch.sort(mc, stable=True).indices
        mc, mw = mc[order], mw[order]
        first = torch.ones_like(mc, dtype=torch.bool)
        first[1:] = mc[1:] != mc[:-1]
        start = torch.cummax(torch.where(
            first, torch.arange(mc.numel(), device=dev), 0), 0).values
        rank = torch.arange(mc.numel(), device=dev) - start
        for k in range(int(rank.max()) + 1):
            at = rank == k
            c = mc[at]
            table[c] = flush_subnormals(table[c] + mw[at])
    return table


def _runs(*keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """For entries sorted by ``keys`` (equal keys adjacent): (group id of
    each entry, rank within its group, whether it ends its group)."""
    n = keys[0].numel()
    new = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
    new[:1] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    gid = torch.cumsum(new, 0) - 1
    pos = torch.arange(n, device=keys[0].device)
    start = torch.cummax(torch.where(new, pos, 0), 0).values
    last = torch.ones_like(new)
    last[:-1] = new[1:]
    return gid, pos - start, last


def _plus_zero(acc: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """``acc`` after adds of +0 ``where`` set: a sum of -0 reads +0."""
    return torch.where(where & (acc == 0), 0.0, acc)


def _fadd(acc: torch.Tensor, v: torch.Tensor,
          reset: torch.Tensor) -> torch.Tensor:
    """One flushed add of XLA's sum, after adds of +0 where ``reset``."""
    return flush_subnormals(_plus_zero(acc, reset) + v)


def pallas_f32_build(keys: torch.Tensor, weights: torch.Tensor, *,
                     rows: int, width: int, seed: int = 0,
                     family: str = "kernel", shards: int = 1,
                     block: int = 256) -> torch.Tensor:
    """f32 tables [shards, rows, width] summed as the Pallas build sums
    them: each block of ``block`` keys of a lane gives every counter the sum
    of its keys' one-hot products, and the table adds each block's sum in
    block order, a flush after each. A key that misses the counter adds +0
    (whatever its weight), which only turns a sum of -0 into +0.

    A block of more than 32 keys goes through XLA's CPU reduction (ROADMAP
    Queue 3 A29): windows of 32 (``tree_windows``), each summed in order
    from +0, then the window sums in order from +0, every add flushed. So
    each window, block or table sum is walked over its hits alone, a +0
    added first where a miss, a window or a block without a hit comes
    between, in rounds across all of them at once. A block of 32 keys or
    fewer is XLA's fused loop, whose order LLVM picks (A30,
    ``short_block_order``): its block sums are ``_short_block_sums``. A
    lane's last block may be shorter (the ops entry point pads to whole
    blocks)."""
    m = keys.shape[0]
    dev = keys.device
    n = m // shards
    nbl = -(-n // block) if n else 0
    exact = _integral_sums(keys, weights.to(torch.float32), rows=rows,
                           width=width, seed=seed, family=family,
                           shards=shards)
    if exact is not None:
        return exact
    wf = flush_subnormals(weights.to(torch.float32))
    idx = torch.arange(m, device=dev)
    lane = idx // max(n, 1)
    j = idx - lane * n
    blk = j // block
    gblk = lane * nbl + blk
    bstart = lane * n + blk * block
    blen = torch.clamp(n - blk * block, max=block)
    nwin, front = tree_windows(blen)
    win = (j - blk * block + front) // 32
    wstart = bstart + torch.clamp(32 * win - front, min=0)
    wend = bstart + torch.minimum(blen, 32 * (win + 1) - front)
    table = torch.zeros(shards * rows * width, dtype=torch.float32,
                        device=dev)
    cols = row_hashes(keys, rows, width, seed, family)
    for r in range(rows):
        hit = torch.nonzero(cols[:, r] >= 0).flatten()
        if not hit.numel():
            continue
        cell = (lane[hit] * rows + r) * width + cols[hit, r]
        if block <= 32:
            cb, gbb, bs = _short_block_sums(
                cell, gblk[hit], j[hit] - blk[hit] * block, wf[hit],
                shards * nbl, block, short_block_order(block, width, r))
        else:
            cb, gbb, bs = _window_block_sums(cell, hit, gblk, win, wstart,
                                             wend, nwin, wf)
        # the table: block sums in block order
        gc, kc, endc = _runs(cb)
        lane0 = (cb // (rows * width)) * nbl
        prevb = torch.where(kc == 0, lane0 - 1, torch.roll(gbb, 1))
        t = torch.zeros(int(gc[-1]) + 1, device=dev)
        for k in range(int(kc.max()) + 1):
            at = kc == k
            t[gc[at]] = _fadd(t[gc[at]], bs[at], gbb[at] > prevb[at] + 1)
        t = _plus_zero(t, gbb[endc] < lane0[endc] + nbl - 1)
        table[cb[endc]] = t
    return table.reshape(shards, rows, width)


def _window_block_sums(cell, hit, gblk, win, wstart, wend, nwin, wf):
    """(cell, global block, sum) of every (counter, block) with a hit, in
    (counter, block) order: XLA's windowed reduction of a block of more than
    32 keys (A29), walked over the hits of ``hit``'s entries."""
    dev = cell.device
    order = torch.sort(cell, stable=True).indices
    g, cell = hit[order], cell[order]
    gb, wn = gblk[g], win[g]
    # window sums, hit by hit
    ga, ka, enda = _runs(cell, gb, wn)
    prev = torch.where(ka == 0, wstart[g] - 1, torch.roll(g, 1))
    acc = torch.zeros(int(ga[-1]) + 1, device=dev)
    for k in range(int(ka.max()) + 1):
        at = ka == k
        acc[ga[at]] = _fadd(acc[ga[at]], wf[g[at]], g[at] > prev[at] + 1)
    ge = g[enda]
    acc = _plus_zero(acc, ge < wend[ge] - 1)
    # block sums over the windows with a hit
    cw, gbw, ww = cell[enda], gb[enda], wn[enda]
    gbk, kb, endb = _runs(cw, gbw)
    prevw = torch.where(kb == 0, -1, torch.roll(ww, 1))
    bs = torch.zeros(int(gbk[-1]) + 1, device=dev)
    for k in range(int(kb.max()) + 1):
        at = kb == k
        bs[gbk[at]] = _fadd(bs[gbk[at]], acc[at], ww[at] > prevw[at] + 1)
    bs = _plus_zero(bs, ww[endb] < nwin[ge[endb]] - 1)
    return cw[endb], gbw[endb], bs


# XLA's fused loop for a block of at most 32 keys (ROADMAP Queue 3 A30): the
# first block that LLVM vectorises, by the row's place in the kernel (row 0
# is its own fusion; the others add into the table in theirs) and by whether
# the width is a power of two. At a width of 1 no block is vectorised.
SHORT_VECTOR_FROM = {(0, True): 22, (0, False): 15, (1, True): 20,
                     (1, False): 14}


def short_block_order(block: int, width: int, row: int
                      ) -> tuple[int, int, int]:
    """(VF, UF, epi): how XLA's CPU code sums a counter's one-hot products
    over a block of ``block`` <= 32 keys in row ``row`` of the Pallas build
    (ROADMAP Queue 3 A30, read from the fused loop's LLVM IR and held, by
    ``scripts/probe_xla_short_blocks.py``, on every block of 1 to 32 at
    widths 1 to 16, 64, 1024 and 4096 in rows 0 to 3 of builds of 1 to 4
    rows). (1, 1, 1) is the loop in key order. Else the loop is vectorised:
    key i of the first (block // (VF * UF)) * VF * UF goes to lane i mod VF
    of accumulator (i // VF) mod UF, each lane adding its keys in order; the
    accumulators add lane by lane (the second plus the first, then the
    third plus that, ...), and the VF lanes combine as a halving tree (lane
    l plus lane l + VF/2, ...). epi = 0 is a tail-folded loop: the last
    iteration is masked, and a lane past the block adds nothing; epi = 1
    adds the rest of the keys in order; epi = E > 1 is a vectorised
    epilogue of E lanes, the sum so far on lane 0, its keys E at a time,
    a halving tree, then the rest in order."""
    p2 = width & (width - 1) == 0
    if width == 1 or block < SHORT_VECTOR_FROM[(min(row, 1), p2)]:
        return 1, 1, 1
    if block < 16:
        return 8, 1, 0
    if 20 <= block < 24:
        return 4, 4, 2
    return 8, 1, 1


def _halve(v: list) -> torch.Tensor:
    """The halving tree of a power-of-two list of lanes (XLA's vector
    reduction): lane l plus lane l + n/2, until one is left."""
    while len(v) > 1:
        h = len(v) // 2
        v = [ftz_add(v[i], v[i + h]) for i in range(h)]
    return v[0]


def short_block_sum(leaves: torch.Tensor, order: tuple[int, int, int]
                    ) -> torch.Tensor:
    """[G, B] flushed one-hot products (a miss +0, the first already added
    to +0) -> [G] sums in the order ``order`` (``short_block_order``), every
    add flushed. A lane that takes no key holds -0, the vector reductions'
    identity."""
    B = leaves.shape[1]
    vf, uf, epi = order
    if vf == 1:
        acc = leaves[:, 0]
        for i in range(1, B):
            acc = ftz_add(acc, leaves[:, i])
        return acc
    step = vf * uf
    main = -(-B // step) * step if epi == 0 else B // step * step
    acc = [[None] * vf for _ in range(uf)]
    for i in range(min(main, B)):
        u, lane = (i // vf) % uf, i % vf
        x = leaves[:, i]
        acc[u][lane] = x if acc[u][lane] is None else ftz_add(acc[u][lane], x)
    neg = torch.full_like(leaves[:, 0], -0.0)
    acc = [[neg if a is None else a for a in row] for row in acc]
    lanes = acc[0]
    for u in range(1, uf):
        lanes = [ftz_add(acc[u][i], lanes[i]) for i in range(vf)]
    s = _halve(lanes)
    i = min(main, B)
    if epi > 1 and B - i >= epi:
        v = [s] + [None] * (epi - 1)
        while B - i >= epi:
            for k in range(epi):
                x = leaves[:, i + k]
                v[k] = x if v[k] is None else ftz_add(v[k], x)
            i += epi
        s = _halve([neg if x is None else x for x in v])
    for k in range(i, B):
        s = ftz_add(s, leaves[:, k])
    return s


def _short_block_sums(cell, gblk, pos, w, nblocks, block, order):
    """(cell, global block, sum) of every (counter, block) with a hit, in
    (counter, block) order, for blocks of at most 32 keys: each group's
    keys as a dense row of one-hot products (``pos``: a hit's place in its
    block), summed by ``short_block_sum``."""
    groups, inv = torch.unique(cell * nblocks + gblk, return_inverse=True)
    leaves = torch.zeros((groups.numel(), block), dtype=torch.float32,
                         device=cell.device)
    leaves[inv, pos] = w
    # the reduction's init, +0, added to the first key's product
    leaves[:, 0] = ftz_add(leaves[:, 0], torch.zeros_like(leaves[:, 0]))
    return groups // nblocks, groups % nblocks, short_block_sum(leaves,
                                                                order)


def _integral_sums(keys: torch.Tensor, w: torch.Tensor, *, rows: int,
                   width: int, seed: int, family: str,
                   shards: int) -> torch.Tensor | None:
    """The f32 tables [shards, rows, width] when every weight is an integer
    and each counter's sum of |weight| stays below 2^24, else None. Then
    every partial sum of every order is an exact integer, and a sum from +0
    that reaches 0 reads +0, so every order gives these bits: the main
    path's weights take this sum (one index_add in f64), not the walk of
    ``pallas_f32_build``."""
    if not bool((torch.isfinite(w) & (w == w.trunc())).all()):
        return None
    m = keys.shape[0]
    dev = keys.device
    lane = torch.arange(m, device=dev) // max(m // shards, 1)
    col = row_hashes(keys, rows, width, seed, family)
    hit = col >= 0
    cell = ((lane[:, None] * rows + torch.arange(rows, device=dev)) * width
            + col)[hit]
    w64 = w.to(torch.float64)[:, None].expand(m, rows)[hit]
    size = shards * rows * width
    bound = torch.zeros(size, dtype=torch.float64, device=dev).index_add_(
        0, cell, w64.abs())
    if bool((bound >= float(1 << 24)).any()):
        return None
    table = torch.zeros(size, dtype=torch.float64, device=dev).index_add_(
        0, cell, w64)
    return (table.to(torch.float32) + 0.0).reshape(shards, rows, width)


def tree_windows(length: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(windows, front pads) of XLA's CPU sum of ``length`` f32 values
    (ROADMAP Queue 3 A29): up to 32 values are one window; more are cut into
    ceil(length / 32) windows of 32, the first short by (32 * windows -
    length) // 2 (the front pads, which add +0 to a sum that starts at +0)
    and the last by the rest."""
    many = length > 32
    nwin = torch.where(many, -(-length // 32), 1)
    return nwin, torch.where(many, (32 * nwin - length) // 2, 0)


@lru_cache(maxsize=None)
def build_plan(device: torch.device, lanes: int, shard_len: int, rows: int,
               width: int, is_int: int) -> tuple[int, int, int]:
    """(CTAs a lane, the int32 shadow's limit, workspace bytes) of the CUDA
    build on ``device``, as ``csrc/cms.cu`` lays it out (``cms_build_plan``;
    the build takes the same plan itself)."""
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        err = library_fn("cms_build_plan",
                         [I32, I64, I32, I32, I32,
                          ctypes.POINTER(ctypes.c_longlong)], I32)(
            lanes, shard_len, rows, width, is_int, out)
    if err:
        raise RuntimeError(f"cms_build_plan failed: cudaError {err}")
    return tuple(int(v) for v in out)


def _kernel_weights(weights: torch.Tensor | None):
    """(weights as the C build takes them, the C table type): an integer
    table is built as int32 (1) from weights by value mod 2^32, an f32 one
    as f32 (0), an f16 one in f16 (2)."""
    if weights is None:
        return None, 1
    if weights.dtype in INT_TABLES:
        w = (weights.view(torch.int32) if weights.dtype == torch.uint32
             else weights.to(torch.int32))
        return w.contiguous(), 1
    if weights.dtype == torch.float16:
        return weights.contiguous(), 2
    return weights.to(torch.float32).contiguous(), 0


def cms_build_kernel(keys: torch.Tensor, weights: torch.Tensor | None, *,
                     rows: int, width: int, seed: int = 0,
                     family: str = "kernel", shards: int = 1,
                     block: int = 256) -> torch.Tensor:
    """Count-Min tables [shards, rows, width] of the weights' dtype, lane s
    over the contiguous keys [s * m/S, (s+1) * m/S). The C build lays
    itself out (``build_plan``). An f32 table of the kernels' family sums
    by blocks of ``block`` keys (``pallas_f32_build``)."""
    m = keys.shape[0]
    fam = _family(family, keys)
    if rows < 1 or width < 1:
        raise ValueError(f"a sketch needs rows, width >= 1, got {rows}, "
                         f"{width}")
    if shards < 1 or m % shards:
        raise ValueError(f"{m} keys are not a multiple of shards={shards}")
    if weights is not None and (weights.shape != (m,)
                                or weights.dtype not in DTYPES):
        raise ValueError(f"weights must be [{m}] of one of {DTYPES}, got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if not keys.is_cuda:
        return cms_build_plain(keys, weights, rows=rows, width=width,
                               seed=seed, family=family, shards=shards,
                               block=block)
    k = _keys_u32(keys)
    check_cuda("keys", k, torch.uint32)
    if weights is not None:
        check_cuda("weights", weights, weights.dtype, keys.device)
    if shards > 65535:
        raise ValueError(f"the CUDA build takes at most 65535 lanes, got "
                         f"{shards}")
    dev = keys.device
    dtype = torch.int32 if weights is None else weights.dtype
    w, ttype = _kernel_weights(weights)
    # a table the build does not write whole is zeroed first: the f16 build
    # lays its rows out itself
    staged = ttype < 2 and rows * width * 4 <= MAX_SMEM
    n = m // shards
    table = (torch.empty if staged else torch.zeros)(
        (shards, rows, width), dtype=_C_TABLES[ttype], device=dev)
    if m:
        # the plan's workspace, 16 bytes for an f32 build's sign flags, and
        # the last blocks of the kernels' family's block-order walk
        nbytes = (-(-build_plan(dev, shards, n, rows, width, ttype)[2] // 16)
                  * 16 + 16 if ttype < 2 else 16)
        if ttype == 0 and w is not None and fam != 1:
            if not 1 <= block <= 1024:
                raise ValueError(f"the CUDA build sums blocks of 1 to 1024 "
                                 f"keys, got block={block}")
            nbytes += 4 * shards * rows * width
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        CMS_BUILD.launch(dev, ptr(k), None if w is None else ptr(w),
                         ptr(table), ptr(work), shards, n, rows, width,
                         seed & 0xFFFFFFFF, fam, ttype, block)
    else:
        table.zero_()
    return kernel_table(table, dtype)


def kernel_table(table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The C build's int32, f32 or f16 table as a table of ``dtype``
    (integers wrapped into it)."""
    if dtype == torch.uint32:
        return table.view(torch.uint32)
    if table.dtype == torch.int32 and dtype != torch.int32:
        return wrap_to(table, dtype)
    return table


def _int_threshold(threshold, dtype: torch.dtype) -> int:
    """An integer table compares est > threshold in integers. A Python int
    is weakly typed, as JAX compares an array with it (x64 off): outside
    int32 it raises OverflowError, else it wraps into the table's dtype;
    any other number compares as its floor."""
    if isinstance(threshold, int):
        if not -(1 << 31) <= threshold < (1 << 31):
            raise OverflowError(f"Python int {threshold} too large to "
                                "convert to int32")
        bits = torch.iinfo(dtype).bits
        t = threshold & ((1 << bits) - 1)
        return t - (1 << bits) if dtype.is_signed and t >> (bits - 1) else t
    t = math.floor(threshold)
    return max(-_I64_MAX - 1, min(_I64_MAX, t))


def min_rows(reads: torch.Tensor) -> torch.Tensor:
    """f32 [m, rows] -> [m]: the rows' minimum as XLA's takes it, row by row
    as the card's kernel folds it: a NaN of any row wins, and -0 is below
    +0."""
    e = reads[:, 0]
    for r in range(1, reads.shape[1]):
        v = reads[:, r]
        e = torch.where((v < e) | v.isnan() | ((v == e) & v.signbit()), v, e)
    return e


def onehot_reads(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32 [m, rows]: what the Pallas query reads of an f32 table, the
    one-hot product sum_c onehot[c] * T[r, c] (``gather_rows``). Row r's
    read of column c is NaN when another counter of row r is not finite
    (0 * inf) or T[r, c] is NaN, else T[r, c] + 0.0, subnormals flushed: -0
    reads +0. A dropped probe (c = -1) reads +0, or NaN in a row that holds
    a non-finite counter."""
    nonfinite = (~torch.isfinite(t)).sum(1)
    got = flush_subnormals(t[torch.arange(t.shape[0], device=t.device),
                             idx.clamp(min=0)])
    hit = idx >= 0
    ok = (nonfinite == 0) | ((nonfinite == 1) & got.isinf() & hit)
    read = torch.where(hit, got + 0.0, 0.0)
    return torch.where(ok, read, float("nan"))


def cms_query_plain(table: torch.Tensor, keys: torch.Tensor, *,
                    seed: int = 0, family: str = "kernel",
                    threshold=None) -> torch.Tensor:
    """Plain query: est[m] = min over rows of table[r, hash_r(key)] (a
    dropped probe reads 0), or keep bool[m] = est > threshold when a
    threshold is given.

    A float table (f16 by its f32 values, which XLA's f16 arithmetic takes)
    is read as the reference reads it. The kernels' family is the Pallas
    query: the one-hot reads (``onehot_reads``), their minimum with the
    start value float32(3.4e38), NaN-propagating, so an estimate is at most
    3.4e38. The engine's family is ``jnp.min`` of the gathered counters
    (``min_rows``, subnormals flushed), a plain copy of the one counter
    when rows == 1. The threshold compares with subnormals flushed."""
    rows, width = table.shape
    idx = row_hashes(keys, rows, width, seed, family)
    if table.dtype in INT_TABLES:
        got = by_value_i64(table)[torch.arange(rows, device=table.device),
                                  idx.clamp(min=0)]
        est = torch.where(idx < 0, 0, got).amin(-1)
        if threshold is None:
            return wrap_to(est, table.dtype)
        return est > _int_threshold(threshold, table.dtype)
    t = table.to(torch.float32)
    if _family(family) != 1:
        est = min_rows(onehot_reads(t, idx)).clamp(max=float(POS))
    else:
        got = t[torch.arange(rows, device=t.device), idx]
        est = got[:, 0] if rows == 1 else min_rows(flush_subnormals(got))
    if threshold is None:
        return est.to(table.dtype)
    thr = torch.tensor(threshold, dtype=table.dtype).to(torch.float32)
    return flush_subnormals(est) > flush_subnormals(thr)


@lru_cache(maxsize=None)
def query_plan(device: torch.device, rows: int, width: int, ttype: int,
               fam: int) -> tuple[int, int, int]:
    """(route: 1 the table staged in shared memory, 0 gathered from global
    memory; the persistent grid's CTAs; workspace bytes) of the CUDA query
    on ``device``, as ``csrc/cms.cu`` plans it (``cms_query_plan``), asked
    once a device and shape."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = library_fn("cms_query_plan",
                         [I32, I32, I32, I32, ctypes.POINTER(ctypes.c_int)],
                         I32)(rows, width, ttype, fam, out)
    if err:
        raise RuntimeError(f"cms_query_plan failed: cudaError {err}")
    return tuple(int(v) for v in out)


def _float_threshold(threshold, dtype: torch.dtype) -> float:
    """The threshold rounded into the table's float dtype, as JAX rounds a
    weakly typed one, and flushed as XLA compares a subnormal."""
    t = float(torch.tensor(threshold, dtype=dtype))
    return math.copysign(0.0, t) if abs(t) < FLT_MIN else t


def cms_query_kernel(table: torch.Tensor, keys: torch.Tensor, *,
                     seed: int = 0, family: str = "kernel",
                     threshold=None) -> torch.Tensor:
    """est[m] (the table's dtype) = min over rows of the hashed counters;
    with ``threshold``, the fused keep bool[m] = est > threshold instead.
    Read as ``cms_query_plain`` says."""
    fam = _family(family, keys)
    if table.ndim != 2 or table.dtype not in DTYPES:
        raise ValueError(f"table must be [rows, width] of one of {DTYPES}, "
                         f"got {table.dtype} {tuple(table.shape)}")
    if not keys.is_cuda:
        return cms_query_plain(table, keys, seed=seed, family=family,
                               threshold=threshold)
    rows, width = table.shape
    m = keys.shape[0]
    k = _keys_u32(keys)
    check_cuda("keys", k, torch.uint32)
    check_cuda("table", table, table.dtype, keys.device)
    dtype = table.dtype
    # the C query takes f32, int32 or uint32 tables: narrower integers by
    # value in int32, f16 in f32 (est converted back, exactly)
    if dtype == torch.uint32:
        ttype = 2
    elif dtype in INT_TABLES:
        ttype, table = 1, table.to(torch.int32)
    else:
        ttype, table = 0, table.to(torch.float32)
    dev = keys.device
    est = keep = None
    thr_i, thr_f = 0, 0.0
    if threshold is None:
        est = query_out(k, m, table.dtype)
    else:
        keep = query_out(k, m, torch.bool)
        if ttype:
            thr_i = _int_threshold(threshold, dtype)
        else:
            thr_f = _float_threshold(threshold, dtype)
    if m:
        _, ctas, nbytes = query_plan(dev, rows, width, ttype, fam)
        work = torch.empty(nbytes // 4, dtype=torch.int32, device=dev) \
            if nbytes else None
        CMS_QUERY.launch(dev, ptr(table), ptr(k),
                         None if est is None else ptr(est),
                         None if keep is None else ptr(keep), m, rows, width,
                         seed & 0xFFFFFFFF, fam, ttype, thr_i, thr_f, ctas,
                         None if work is None else ptr(work))
    if threshold is not None:
        return keep
    return est.view(torch.uint32) if ttype == 2 else est.to(dtype)
