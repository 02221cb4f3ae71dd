"""Plain PyTorch versions of the pass-1 pruning kernels (block semantics).

Ports of ``ref.topn_block_ref``, ``ref.distinct_block_ref`` and
``ref.skyline_block_ref`` of the JAX package. Block semantics are the paper's §9 multi-entry rule: within a block
of B entries every prune decision reads the pre-block state, and each row
takes at most one insert per block. At B = 1 they are the per-entry scans of
``core.topn.topn_rand_prune`` and ``core.distinct.distinct_prune(policy="fifo")``.
``distinct_lru_ref`` is the per-entry LRU scan (no block form).

Both take one stream ``[m]`` or S lane streams ``[S, n]`` and loop over
blocks, vectorised across the B entries of a block and the S lanes. As in
the JAX package, a stream is cut to a whole number of blocks. These are the
versions the CPU runs, and what the CUDA kernels are held against on a card.

``bloom_build_ref`` / ``bloom_query_ref`` are the Pallas Bloom kernels'
``ref.py`` counterparts on the f32 0/1 view of the filter.
"""
from __future__ import annotations

import torch

from ..constants import NEG
from ..core.hashing import as_u32, hash_mod
from ..core.skyline import score as skyline_score
from .bloom_filter import (bloom_build_plain, bloom_query_plain, pack_bits,
                           unpack_bits)


def _lanes(values: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    lanes = values if values.ndim == 2 else values[None]
    nb = lanes.shape[1] // block
    return lanes[:, : nb * block], nb


def topn_block_ref(values: torch.Tensor, *, d: int, w: int, block: int,
                   seed: int = 0, return_state: bool = False):
    """Randomized TOP-N matrix, block semantics: keep bool[m] (or [S, n]),
    plus the final f32[d, w] (or [S, d, w]) matrix when ``return_state``."""
    one = values.ndim == 1
    x, nb = _lanes(values.to(torch.float32), block)
    S, dev = x.shape[0], x.device
    rows_all = hash_mod(torch.arange(nb * block, device=dev), d, seed)
    state = torch.full((S, d, w), float(NEG), dtype=torch.float32, device=dev)
    keep = torch.empty(x.shape, dtype=torch.bool, device=dev)
    idxw = torch.arange(w, device=dev)
    for c in range(nb):
        sl = slice(c * block, (c + 1) * block)
        xb, rows = x[:, sl], rows_all[sl]
        row_min = state[:, :, -1]
        keep[:, sl] = xb >= row_min[:, rows]
        cand = torch.full((S, d), float(NEG), dtype=torch.float32, device=dev)
        cand = cand.scatter_reduce(1, rows.expand(S, -1), xb, "amax")
        do = cand > row_min
        pos = (cand[:, :, None] <= state).sum(-1, keepdim=True)
        shifted = torch.where(idxw > pos, state.roll(1, dims=2), state)
        inserted = torch.where(idxw == pos, cand[:, :, None], shifted)
        state = torch.where(do[:, :, None], inserted, state)
    if one:
        keep, state = keep[0], state[0]
    return (keep, state) if return_state else keep


def distinct_block_ref(values: torch.Tensor, *, d: int, w: int, block: int,
                       seed: int = 0, return_state: bool = False):
    """FIFO d x w fingerprint cache, block semantics: keep bool[m] (or
    [S, n]), plus the final (slots uint32, valid bool, head int32) state
    when ``return_state``."""
    one = values.ndim == 1
    v, nb = _lanes(values, block)
    x = as_u32(v)                       # int64 lanes: exact uint32 compares
    S, dev = x.shape[0], x.device
    rows_all = hash_mod(x, d, seed)     # [S, nb * block]
    # row d is a dump row for the entries that insert nothing, so that a
    # block's inserts are one scatter with no host synchronisation
    slots = torch.zeros((S, d + 1, w), dtype=torch.int64, device=dev)
    valid = torch.zeros((S, d + 1, w), dtype=torch.bool, device=dev)
    head = torch.zeros((S, d + 1), dtype=torch.int64, device=dev)
    keep = torch.empty(x.shape, dtype=torch.bool, device=dev)
    lane = torch.arange(S, device=dev)[:, None]
    iota = torch.arange(block, device=dev).expand(S, -1)
    for c in range(nb):
        sl = slice(c * block, (c + 1) * block)
        xb, rows = x[:, sl], rows_all[:, sl]
        hit = ((slots[lane, rows] == xb[:, :, None])
               & valid[lane, rows]).any(-1)
        miss = ~hit
        keep[:, sl] = miss
        cand = torch.where(miss, iota, block)
        first = torch.full((S, d), block, dtype=torch.int64, device=dev)
        first = first.scatter_reduce(1, rows, cand, "amin")
        insert = miss & (first.gather(1, rows) == iota)
        h = head.gather(1, rows)
        r = torch.where(insert, rows, d)
        col = torch.where(insert, h, 0)
        slots[lane, r, col] = xb
        valid[lane, r, col] = True
        head[lane, r] = (h + 1) % w
    slots = slots[:, :d].to(torch.int32).view(torch.uint32)
    valid = valid[:, :d].contiguous()
    head = head[:, :d].to(torch.int32)
    if one:
        keep, slots, valid, head = keep[0], slots[0], valid[0], head[0]
    return (keep, (slots, valid, head)) if return_state else keep


def distinct_lru_ref(values: torch.Tensor, *, d: int, w: int, seed: int = 0,
                     return_state: bool = False):
    """LRU d x w fingerprint cache, per-entry semantics (the JAX package's
    ``core.distinct._step`` with policy "lru"): keep bool[m] (or [S, n]),
    plus the final (slots uint32, valid bool, head int32 = 0) state when
    ``return_state``. A hit moves its first matching slot to the front; a
    miss inserts at the front and drops the last slot. One loop step an
    entry, vectorised across the S lanes."""
    one = values.ndim == 1
    x = as_u32(values[None] if one else values)   # int64: exact compares
    S, n = x.shape
    dev = x.device
    rows = hash_mod(x, d, seed)
    slots = torch.zeros((S, d, w), dtype=torch.int64, device=dev)
    valid = torch.zeros((S, d, w), dtype=torch.bool, device=dev)
    keep = torch.empty((S, n), dtype=torch.bool, device=dev)
    lane = torch.arange(S, device=dev)
    idx = torch.arange(w, device=dev)
    for t in range(n):
        r, v = rows[:, t], x[:, t]
        sr, vr = slots[lane, r], valid[lane, r]
        hitvec = (sr == v[:, None]) & vr
        hit = hitvec.any(1)
        limit = torch.where(hit, hitvec.to(torch.int8).argmax(1), w - 1)
        shift = (idx >= 1) & (idx <= limit[:, None])
        ns = torch.where(shift, sr.roll(1, 1), sr)
        nv = torch.where(shift, vr.roll(1, 1), vr)
        ns[:, 0] = v
        nv[:, 0] = True
        slots[lane, r] = ns
        valid[lane, r] = nv
        keep[:, t] = ~hit
    slots = slots.to(torch.int32).view(torch.uint32)
    head = torch.zeros((S, d), dtype=torch.int32, device=dev)
    if one:
        keep, slots, valid, head = keep[0], slots[0], valid[0], head[0]
    return (keep, (slots, valid, head)) if return_state else keep


def skyline_block_ref(points: torch.Tensor, *, w: int, block: int,
                      score: str = "aph", form: str = "engine",
                      return_state: bool = False):
    """w-point store, block semantics: keep bool[m] (or [S, n]) for f32
    points [m, D] (or lanes [S, n, D]), plus the final (points f32[w, D],
    scores f32[w]) store (or [S, w, D], [S, w]) when ``return_state``.

    keep: no stored point with score > NEG dominates the entry (pre-block
    store). Insert: the w rounds of "best remaining score of the block, ties
    to the lowest index, sorted-inserted if it beats the last stored score"
    leave the first w of the stable descending merge of the store and the
    block's top-w candidates, store first; that merge is what runs here.
    The scores of every entry and the top-w candidates of every block do not
    depend on the store, so they are computed once, before the block loop.
    ``form`` is the APH association (``core.skyline``): the JAX package's
    oracle uses the engine's, its Pallas kernel the kernel's.
    """
    one = points.ndim == 2
    x = (points[None] if one else points).to(torch.float32)
    S, n, D = x.shape
    nb = n // block
    x = x[:, : nb * block]
    dev = x.device
    h = skyline_score(x, score, form).reshape(S, nb, block)
    xb = x.reshape(S, nb, block, D)
    r = min(w, block)
    top = torch.sort(h, dim=-1, descending=True, stable=True).indices[..., :r]
    cand_s = h.gather(-1, top)
    cand_p = xb.gather(2, top[..., None].expand(-1, -1, -1, D))
    pts = torch.zeros((S, w, D), dtype=torch.float32, device=dev)
    scs = torch.full((S, w), float(NEG), dtype=torch.float32, device=dev)
    keep = torch.empty((S, nb * block), dtype=torch.bool, device=dev)
    for c in range(nb):
        xc = xb[:, c, :, None, :]                       # [S, B, 1, D]
        dom = ((xc <= pts[:, None]).all(-1) & (xc < pts[:, None]).any(-1)
               & (scs > NEG)[:, None, :]).any(-1)
        keep[:, c * block:(c + 1) * block] = ~dom
        all_s = torch.cat([scs, cand_s[:, c]], 1)
        all_p = torch.cat([pts, cand_p[:, c]], 1)
        o = torch.sort(all_s, dim=1, descending=True, stable=True).indices[:, :w]
        scs = all_s.gather(1, o)
        pts = all_p.gather(1, o[..., None].expand(-1, -1, D))
    if one:
        keep, pts, scs = keep[0], pts[0], scs[0]
    return (keep, (pts, scs)) if return_state else keep


def bloom_build_ref(keys: torch.Tensor, *, nbits: int, num_hashes: int,
                    seed: int = 0) -> torch.Tensor:
    """f32[nbits] 0/1 Bloom bits of ``keys`` (hashes ``seed + 101 h``)."""
    words = bloom_build_plain(keys, nbits=nbits, num_hashes=num_hashes,
                              seed=seed, family="kernel")
    return unpack_bits(words, nbits).to(torch.float32)


def bloom_query_ref(bits: torch.Tensor, keys: torch.Tensor, *,
                    num_hashes: int, seed: int = 0) -> torch.Tensor:
    """int32[m]: 1 where every probed bit of ``bits`` (f32 0/1) is > 0.5."""
    nbits = bits.shape[0]
    return bloom_query_plain(pack_bits(bits > 0.5), keys, nbits=nbits,
                             num_hashes=num_hashes, seed=seed,
                             family="kernel").to(torch.int32)
