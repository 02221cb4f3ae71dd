"""Plain PyTorch versions of the pass-1 pruning kernels (block semantics).

Ports of ``ref.topn_block_ref``, ``ref.distinct_block_ref`` and
``ref.skyline_block_ref`` of the JAX package. Block semantics are the paper's §9 multi-entry rule: within a block
of B entries every prune decision reads the pre-block state, and each row
takes at most one insert per block. At B = 1 they are the per-entry scans of
``core.topn.topn_rand_prune`` and ``core.distinct.distinct_prune(policy="fifo")``.
``distinct_lru_ref`` is the per-entry LRU scan (no block form).
``skyline_block_ref`` at block=1 is the engine's per-entry SKYLINE scan
(``skyline_scan_ref``), which inserts NaN scores as the JAX package's
``lax.scan`` does.

DISTINCT compares as the JAX package does: a uint32 stream by value; a
float32 stream is hashed by its bits, but its slots hold the uint32
conversion of the value and are compared with the value in f32
(``distinct_keys``).

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
from .common import flush_subnormals as ftz
from .common import ordered_i32, unordered_f32


def _lanes(values: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    lanes = values if values.ndim == 2 else values[None]
    nb = lanes.shape[1] // block
    return lanes[:, : nb * block], nb


def topn_block_ref(values: torch.Tensor, *, d: int, w: int, block: int,
                   seed: int = 0, return_state: bool = False,
                   onehot: bool = False, state: torch.Tensor | None = None,
                   index_offset: int = 0):
    """Randomized TOP-N matrix, block semantics: keep bool[m] (or [S, n]),
    plus the final f32[d, w] (or [S, d, w]) matrix when ``return_state``.

    A row's candidate from a block is the reference's scatter max of the
    block's entries of that row: NaN if any of them is NaN, whatever its
    sign, else the largest with +0 above -0 (XLA's max), so the max of
    ``ordered_i32``. ``scatter_reduce("amax")`` on the floats would keep
    the first of -0 and +0.

    Every compare flushes f32 subnormals (A25). At B > 1 the candidate is
    that maximum, which XLA flushes too; at B = 1 it is the entry, which
    the engine's scan inserts as it is (a select keeps the bits).

    ``onehot``: the keep of the Pallas kernels (``topn_prune_kernel``,
    ``topn_shard_states_kernel``), which read an entry's row minimum by a
    one-hot product over the d minima (``onehot_keep``); by default the
    minimum itself, as the JAX package's ``ref.topn_block_ref`` and the
    engine's scan read it.

    ``state`` (f32 [d, w] or [S, d, w]) resumes a scan from carried
    matrices, which take the final ones in place; ``index_offset`` is added
    to the shard-local index before it is hashed, mod 2^32 (the engine's
    resumed scan, ``core.topn.topn_rand_prune``)."""
    one = values.ndim == 1
    x, nb = _lanes(values.to(torch.float32), block)
    xf = ftz(x)
    S, dev = x.shape[0], x.device
    rows_all = hash_mod((torch.arange(nb * block, device=dev) + index_offset)
                        & 0xFFFFFFFF, d, seed)
    carried = state
    state = (torch.full((S, d, w), float(NEG), dtype=torch.float32,
                        device=dev) if carried is None
             else carried.reshape(S, d, w).clone())
    keep = torch.empty(x.shape, dtype=torch.bool, device=dev)
    idxw = torch.arange(w, device=dev)
    neg = ordered_i32(torch.full((S, d), float(NEG), device=dev))
    # the block of each row's last insert (onehot_keep reads it)
    tlast = torch.full((S, d), -1, dtype=torch.int64, device=dev)
    # a block touches only its entries' rows: those are read, updated and
    # written back (an entry of a row that recurs writes the same values)
    for c in range(nb):
        sl = slice(c * block, (c + 1) * block)
        xb, rows = (x if block == 1 else xf)[:, sl], rows_all[sl]
        st = state[:, rows]                              # [S, B, w]
        stf = ftz(st)
        keep[:, sl] = xf[:, sl] >= stf[:, :, -1]
        cand = unordered_f32(neg.scatter_reduce(
            1, rows.expand(S, -1), ordered_i32(xb), "amax")[:, rows])
        candf = ftz(cand)
        do = candf > stf[:, :, -1]
        pos = (candf[:, :, None] <= stf).sum(-1, keepdim=True)
        shifted = torch.where(idxw > pos, st.roll(1, dims=2), st)
        inserted = torch.where(idxw == pos, cand[:, :, None], shifted)
        state[:, rows] = torch.where(do[:, :, None], inserted, st)
        if onehot:
            tlast[:, rows] = torch.where(do, c, tlast[:, rows])
    if onehot:
        keep = onehot_keep(keep, state, tlast, d=d, block=block, seed=seed)
    if carried is not None:
        state = carried.copy_(state.reshape(carried.shape)).reshape(S, d, w)
    if one:
        keep, state = keep[0], state[0]
    return (keep, state) if return_state else keep


def onehot_keep(keep: torch.Tensor, states: torch.Tensor,
                tlast: torch.Tensor, *, d: int, block: int,
                seed: int = 0) -> torch.Tensor:
    """The Pallas TOP-N pass 1's keep (``topn_prune_kernel``,
    ``topn_shard_states_kernel``) from the keep that reads each row minimum
    itself: keep [S, n], the final matrices [S, d, w], and the block of each
    row's last insert tlast [S, d].

    The Pallas kernel reads an entry's minimum as the one-hot product
    ``sum_k onehot[k] * rowmin[k]`` (ROADMAP Queue 3 B15), so once one row's
    minimum is +inf, 0 * inf makes every other row's read NaN, and once two
    rows' are, every read. A minimum is never NaN (a NaN candidate inserts
    nothing) nor -inf (NEG is finite), and a row whose minimum is +inf takes
    no insert after, so its minimum became +inf at its last insert. With
    t1 <= t2 the two earliest such blocks of a lane and r1 the row of t1,
    an entry of block b keeps as read directly up to block t1, only in row
    r1 after t1 up to t2 (where the direct read is x >= +inf), and never
    after t2. The CUDA fix-up ``topn_onehot_fixup`` (``csrc/topn.cu``) is
    this function on the card."""
    inf = states[..., -1] == float("inf")                  # [S, d]
    if not bool(inf.any()):
        return keep
    big = torch.iinfo(torch.int64).max
    t, order = torch.sort(torch.where(inf, tlast, big), dim=1, stable=True)
    t1 = t[:, :1]
    t2 = t[:, 1:2] if d > 1 else torch.full_like(t1, big)
    n = keep.shape[1]
    idx = torch.arange(n, device=keep.device)
    blk = (idx // block)[None]
    rows = hash_mod(idx, d, seed)[None]
    return keep & (blk <= t2) & ((blk <= t1) | (rows == order[:, :1]))


_U32_MAX = 0xFFFFFFFF


def distinct_keys(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(key int64, hittable bool) of each DISTINCT entry, same shape as x.

    A slot stores ``key`` and an entry hits a valid slot holding its key
    only when it is hittable. For a uint32 stream (or any integer stream,
    by its 32-bit lanes) the key is the value and every entry is hittable.
    For a float32 stream this is the JAX package's rule: the slot is a
    uint32 array, so it stores the value converted as XLA converts (toward
    zero, saturating, NaN to 0), and the hit test compares the slot with
    the value in f32. Every stored key is an f32-representable integer or
    2^32 - 1, so that compare holds exactly when the slot equals the key and
    the key converts back to the value: non-integers, negatives, NaN, -inf
    and values above 2^32 never hit, and 4.0 hits a slot that 4.5 filled.
    The compare flushes f32 subnormals (A25), so +-1e-40 hits the slot 0.
    """
    if x.dtype != torch.float32:
        key = as_u32(x)
        return key, torch.ones(key.shape, dtype=torch.bool, device=x.device)
    v = x.to(torch.float64)
    key = torch.where(v >= 4294967296.0, float(_U32_MAX), v.trunc())
    key = torch.where(v > 0, key, 0.0).to(torch.int64)
    return key, key.to(torch.float32) == ftz(x)


def distinct_block_ref(values: torch.Tensor, *, d: int, w: int, block: int,
                       seed: int = 0, return_state: bool = False,
                       state: tuple | None = None):
    """FIFO d x w fingerprint cache, block semantics: keep bool[m] (or
    [S, n]), plus the final (slots uint32, valid bool, head int32) state
    when ``return_state``. ``state`` resumes from carried (slots, valid,
    head), which take the final state in place."""
    one = values.ndim == 1
    v, nb = _lanes(values, block)
    x, hittable = distinct_keys(v)      # int64 keys: exact uint32 compares
    S, dev = x.shape[0], x.device
    rows_all = hash_mod(v, d, seed)     # [S, nb * block]
    # row d is a dump row for the entries that insert nothing, so that a
    # block's inserts are one scatter with no host synchronisation
    slots = torch.zeros((S, d + 1, w), dtype=torch.int64, device=dev)
    valid = torch.zeros((S, d + 1, w), dtype=torch.bool, device=dev)
    head = torch.zeros((S, d + 1), dtype=torch.int64, device=dev)
    if state is not None:
        slots[:, :d] = as_u32(state[0].reshape(S, d, w))
        valid[:, :d] = state[1].reshape(S, d, w)
        head[:, :d] = state[2].reshape(S, d).to(torch.int64)
    keep = torch.empty(x.shape, dtype=torch.bool, device=dev)
    lane = torch.arange(S, device=dev)[:, None]
    iota = torch.arange(block, device=dev).expand(S, -1)
    for c in range(nb):
        sl = slice(c * block, (c + 1) * block)
        xb, rows = x[:, sl], rows_all[:, sl]
        hit = ((slots[lane, rows] == xb[:, :, None])
               & valid[lane, rows]).any(-1) & hittable[:, sl]
        miss = ~hit
        keep[:, sl] = miss
        if block == 1:      # one entry a lane: its miss is its row's first
            insert = miss
        else:
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
    if state is not None:
        slots, valid, head = _write_back(state, (slots, valid, head))
    if one:
        keep, slots, valid, head = keep[0], slots[0], valid[0], head[0]
    return (keep, (slots, valid, head)) if return_state else keep


def _write_back(carried: tuple, new: tuple) -> tuple:
    """Copy each new stacked state [S, ...] into the carried tensor it
    resumed from (of the same elements, [S, ...] or one lane's [...]);
    returns the carried tensors, viewed [S, ...]."""
    return tuple(c.copy_(n.reshape(c.shape)).reshape(n.shape)
                 for c, n in zip(carried, new))


def distinct_lru_ref(values: torch.Tensor, *, d: int, w: int, seed: int = 0,
                     return_state: bool = False, state: tuple | None = None):
    """LRU d x w fingerprint cache, per-entry semantics (the JAX package's
    ``core.distinct._step`` with policy "lru"): keep bool[m] (or [S, n]),
    plus the final (slots uint32, valid bool, head int32 = 0) state when
    ``return_state``. A hit moves its first matching slot to the front; a
    miss inserts at the front and drops the last slot. One loop step an
    entry, vectorised across the S lanes. ``state`` resumes from carried
    (slots, valid, head), which take the final state in place (head passes
    through, as the reference's LRU step leaves it)."""
    one = values.ndim == 1
    lanes = values[None] if one else values
    x, hittable = distinct_keys(lanes)            # int64: exact compares
    S, n = x.shape
    dev = x.device
    rows = hash_mod(lanes, d, seed)
    slots = torch.zeros((S, d, w), dtype=torch.int64, device=dev)
    valid = torch.zeros((S, d, w), dtype=torch.bool, device=dev)
    if state is not None:
        slots[:] = as_u32(state[0].reshape(S, d, w))
        valid[:] = state[1].reshape(S, d, w)
    keep = torch.empty((S, n), dtype=torch.bool, device=dev)
    lane = torch.arange(S, device=dev)
    idx = torch.arange(w, device=dev)
    for t in range(n):
        r, v = rows[:, t], x[:, t]
        sr, vr = slots[lane, r], valid[lane, r]
        hitvec = (sr == v[:, None]) & vr & hittable[:, t, None]
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
    head = (torch.zeros((S, d), dtype=torch.int32, device=dev)
            if state is None else state[2].reshape(S, d).clone())
    if state is not None:
        slots, valid, head = _write_back(state, (slots, valid, head))
    if one:
        keep, slots, valid, head = keep[0], slots[0], valid[0], head[0]
    return (keep, (slots, valid, head)) if return_state else keep


def skyline_block_ref(points: torch.Tensor, *, w: int, block: int,
                      score: str = "aph", form: str = "engine",
                      return_state: bool = False,
                      state: tuple | None = None):
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
    A NaN score is the best of its block (``jnp.max``) and spends a round
    without inserting (NaN > S[-1] is False), so NaN candidates drop out of
    the merge. ``form`` is the APH association (``core.skyline``): the JAX
    package's oracle uses the engine's, its Pallas kernel the kernel's.
    At block=1 this is ``skyline_scan_ref``, which alone resumes from a
    carried ``state``.
    """
    if block == 1:
        return skyline_scan_ref(points, w=w, score=score, form=form,
                                return_state=return_state, state=state)
    if state is not None:
        raise ValueError("a carried store resumes the one-entry scan only "
                         "(block=1)")
    one = points.ndim == 2
    x = (points[None] if one else points).to(torch.float32)
    S, n, D = x.shape
    nb = n // block
    x = x[:, : nb * block]
    dev = x.device
    h = skyline_score(x, score, form).reshape(S, nb, block)
    xb = x.reshape(S, nb, block, D)
    r = min(w, block)
    top = torch.sort(ftz(h), dim=-1, descending=True,
                     stable=True).indices[..., :r]
    cand_s = h.gather(-1, top)
    cand_s = torch.where(cand_s.isnan(), float(NEG), cand_s)
    cand_p = xb.gather(2, top[..., None].expand(-1, -1, -1, D))
    pts = torch.zeros((S, w, D), dtype=torch.float32, device=dev)
    scs = torch.full((S, w), float(NEG), dtype=torch.float32, device=dev)
    keep = torch.empty((S, nb * block), dtype=torch.bool, device=dev)
    for c in range(nb):
        xc = ftz(xb[:, c, :, None, :])                  # [S, B, 1, D]
        pf = ftz(pts[:, None])
        dom = ((xc <= pf).all(-1) & (xc < pf).any(-1)
               & (scs > NEG)[:, None, :]).any(-1)
        keep[:, c * block:(c + 1) * block] = ~dom
        all_s = torch.cat([scs, cand_s[:, c]], 1)
        all_p = torch.cat([pts, cand_p[:, c]], 1)
        o = torch.sort(ftz(all_s), dim=1, descending=True,
                       stable=True).indices[:, :w]
        scs = all_s.gather(1, o)
        pts = all_p.gather(1, o[..., None].expand(-1, -1, D))
    if one:
        keep, pts, scs = keep[0], pts[0], scs[0]
    return (keep, (pts, scs)) if return_state else keep


def skyline_scan_ref(points: torch.Tensor, *, w: int, score: str = "aph",
                     form: str = "engine", return_state: bool = False,
                     state: tuple | None = None):
    """The engine's per-entry SKYLINE scan (``core.skyline.skyline_prune``
    of the JAX package, a ``lax.scan``), over points [m, D] or lanes
    [S, n, D]; returns as ``skyline_block_ref``.

    An entry of score h goes to pos = #(stored scores >= h); it is pruned
    when one of the stored points at an index below pos dominates it, and
    it is inserted at pos (the slots after pos shift right) whenever
    pos < w. A NaN score has pos = 0: it is never pruned, always inserted,
    and no later compare counts it, so the store stops being sorted. With
    scores that are neither NaN nor <= NEG this is block semantics at one
    entry a block; an entry whose score is <= NEG also counts the empty
    slots, zero points, as stored, as the reference does.
       ``state`` (points, scores) resumes from a carried store, which takes
    the final one in place.
    """
    one = points.ndim == 2
    x = (points[None] if one else points).to(torch.float32)
    S, n, D = x.shape
    dev = x.device
    h = skyline_score(x, score, form)
    pts = torch.zeros((S, w, D), dtype=torch.float32, device=dev)
    scs = torch.full((S, w), float(NEG), dtype=torch.float32, device=dev)
    if state is not None:
        pts = state[0].reshape(S, w, D).clone()
        scs = state[1].reshape(S, w).clone()
    keep = torch.empty((S, n), dtype=torch.bool, device=dev)
    idx = torch.arange(w, device=dev)
    for t in range(n):
        xt, ht = x[:, t, None, :], h[:, t, None]        # [S, 1, D], [S, 1]
        pos = (ftz(ht) <= ftz(scs)).sum(1, keepdim=True)  # [S, 1]
        xf, pf = ftz(xt), ftz(pts)
        dom = ((idx < pos) & (xf <= pf).all(-1) & (xf < pf).any(-1))
        keep[:, t] = ~dom.any(1)
        shift = idx > pos
        at = idx == pos
        scs = torch.where(at, ht, torch.where(shift, scs.roll(1, 1), scs))
        pts = torch.where(at[..., None], xt, torch.where(
            shift[..., None], pts.roll(1, 1), pts))
    if state is not None:
        pts, scs = _write_back(state, (pts, scs))
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
