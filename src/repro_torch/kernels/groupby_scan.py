"""GROUP BY pass 1 (paper §4.2/§8): the per-lane scan kernel and its plain
version.

``groupby_pass1_kernel`` replaces the ``lax.scan`` of the JAX package's
``core.groupby.groupby_prune`` (``core/groupby.py:80-120``), which has no
Pallas kernel; it carries the engine's ``scan``, ``sharded`` and
``two_pass`` modes. S lanes, one per contiguous shard of the stream, each
with its own d x w cache of (key, f32 aggregate, valid) and per-entry
semantics: a hit folds into the first valid slot holding the key; a miss
shifts the row right, puts (key, fold(init, value)) in slot 0 and pushes the
last slot out. Every entry emits the row's last slot as it was before the
entry, valid when a valid entry missed and pushed a valid slot out. Entries
whose validity is False touch nothing.

Each entry point launches the CUDA kernel for a CUDA tensor and runs the
plain version (a loop over entries, vectorised across lanes) for a CPU
tensor. Both are bit-identical: the folds are f32 adds, compares and
``+ 1.0`` in entry order. The CUDA kernel is the row-parallel walk of
``csrc/groupby.cu``: an entry touches only the row its key hashes to, so
each (lane, row) is walked on its own, in stream order, after a stable
partition (any d, both branches of ``hash_mod``; a row of w > 32 slots
is walked in shared memory).

Keys follow the JAX package's rule (``core/groupby.py:63-90``, ``key_form``):
the slot is uint32 and holds the key converted as XLA converts it; an
integer or bool key converts by value (mod 2^32) and is hashed so; a float
key hits a slot only where the float compare ``slot == key`` holds, and is
hashed by its bits (float32) or by its converted value (float16).
"""
from __future__ import annotations

import torch

from ..constants import NEG, POS
from ..core.hashing import as_u32, hash_mod
from .cms_sketch import wrap_i32
from .ref import distinct_keys
from .common import (I32, P, U32, CudaKernel, check_cuda, check_rowpar,
                     ftz_add, ptr, workspace, xla_maximum, xla_minimum)

GROUPBY_PASS1 = CudaKernel(
    "groupby_pass1",
    [P, P, P, P, P, P, P, P, P, I32, I32, I32, I32, I32, U32, P, P, I32, P])
AGGS = ("sum", "count", "min", "max")
INIT = {"sum": 0.0, "count": 0.0, "min": float(POS), "max": float(NEG)}


def _agg(agg: str) -> int:
    if agg not in AGGS:
        raise ValueError(f"agg must be one of {AGGS}, got {agg!r}")
    return AGGS.index(agg)


def fold(agg: str, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The switch's f32 fold of an aggregate ``a`` with a value ``v``, its
    operands and result flushed as XLA flushes f32 subnormals (A25); MIN
    and MAX as ``jnp.minimum`` / ``jnp.maximum`` (-0 below +0)."""
    if agg == "count":
        return a + 1.0
    if agg == "sum":
        return ftz_add(a, v)
    return xla_minimum(a, v) if agg == "min" else xla_maximum(a, v)


def fold_init(agg: str, init: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A miss's aggregate, fold(init, v): for SUM the value itself, bits
    and all, since XLA simplifies ``0.0 + v`` to ``v`` (-0 and subnormals
    stay)."""
    return v if agg == "sum" else fold(agg, init, v)


def init_state(shards: int, d: int, w: int, agg: str,
               device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Empty caches: keys uint32, aggregates f32 (the fold's init), valid
    bool, each [shards, d, w]."""
    shape = (shards, d, w)
    return (torch.zeros(shape, dtype=torch.int32,
                        device=device).view(torch.uint32),
            torch.full(shape, INIT[agg], dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device))


def key_form(keys: torch.Tensor):
    """(hashed uint32 lanes, stored key int64 by value, hittable bool) of
    each GROUP BY key, as the JAX package treats a key of that dtype: an
    integer or bool key by its value mod 2^32 for all three; a float32 key
    hashed by its bits, a float16 one by its converted value, stored
    converted (toward zero, saturating, NaN and negatives to 0) and hitting
    only where the slot converts back to it in the key's type (float16's
    +inf does: 2^32 - 1 rounds to +inf there)."""
    if not keys.is_floating_point():
        k = as_u32(keys)
        return (wrap_i32(k).view(torch.uint32), k,
                torch.ones(k.shape, dtype=torch.bool, device=keys.device))
    f = keys.to(torch.float32)
    key, hit = distinct_keys(f)
    if keys.dtype == torch.float32:
        return keys.view(torch.uint32), key, hit
    if keys.dtype != torch.float16:
        raise TypeError(f"GROUP BY keys of {keys.dtype} are not taken")
    return (wrap_i32(key).view(torch.uint32), key,
            key.to(torch.float16) == keys)


def groupby_pass1_plain(keys: torch.Tensor, values: torch.Tensor,
                        valid: torch.Tensor | None, *, d: int, w: int,
                        agg: str = "sum", seed: int = 0,
                        state: tuple | None = None):
    """Plain pass 1 over lanes [S, n]: ((ev_k, ev_a, ev_valid) each [S, n],
    (keys, aggs, valid) each [S, d, w]). ``state`` resumes from carried
    caches (keys, aggs, valid), which take the final ones in place."""
    _agg(agg)
    S, n = keys.shape
    dev = keys.device
    hkey, k64, hittable = key_form(keys)
    vals = values.to(torch.float32)
    ok = (torch.ones((S, n), dtype=torch.bool, device=dev) if valid is None
          else valid)
    rows = hash_mod(hkey, d, seed)
    st_k, st_a, st_v = (init_state(S, d, w, agg, dev) if state is None
                        else (t.reshape(S, d, w).clone() for t in state))
    st_k = as_u32(st_k)
    ev_k = torch.empty((S, n), dtype=torch.int64, device=dev)
    ev_a = torch.empty((S, n), dtype=torch.float32, device=dev)
    ev_v = torch.empty((S, n), dtype=torch.bool, device=dev)
    lane = torch.arange(S, device=dev)
    init = torch.full((S,), INIT[agg], dtype=torch.float32, device=dev)
    for t in range(n):
        r, k, v, o = rows[:, t], k64[:, t], vals[:, t], ok[:, t]
        kr, ar, vr = st_k[lane, r], st_a[lane, r], st_v[lane, r]
        hitvec = (kr == k[:, None]) & vr & hittable[:, t, None]
        hit = hitvec.any(1)
        pos = hitvec.to(torch.int8).argmax(1)
        ev_k[:, t] = kr[:, -1]
        ev_a[:, t] = ar[:, -1]
        ev_v[:, t] = vr[:, -1] & ~hit & o
        a_hit = ar.clone()
        a_hit[lane, pos] = fold(agg, ar[lane, pos], v)
        k_miss = torch.cat([k[:, None], kr[:, :-1]], 1)
        a_miss = torch.cat([fold_init(agg, init, v)[:, None], ar[:, :-1]], 1)
        v_miss = torch.cat([torch.ones_like(vr[:, :1]), vr[:, :-1]], 1)
        h, o2 = hit[:, None], o[:, None]
        st_k[lane, r] = torch.where(o2 & ~h, k_miss, kr)
        st_a[lane, r] = torch.where(o2, torch.where(h, a_hit, a_miss), ar)
        st_v[lane, r] = torch.where(o2 & ~h, v_miss, vr)
    st = (wrap_i32(st_k).view(torch.uint32), st_a, st_v)
    if state is not None:
        st = tuple(c.copy_(n.reshape(c.shape)).reshape(n.shape)
                   for c, n in zip(state, st))
    return (wrap_i32(ev_k).view(torch.uint32), ev_a, ev_v), st


def groupby_pass1_kernel(keys: torch.Tensor, values: torch.Tensor,
                         valid: torch.Tensor | None = None, *, d: int, w: int,
                         agg: str = "sum", seed: int = 0, shards: int = 1,
                         state: tuple | None = None):
    """Pass 1 of S lanes over a stream of m keys (``key_form``) and values:
    ((ev_k uint32, ev_a f32, ev_valid bool) each [m], (keys uint32, aggs f32,
    valid bool) each [shards, d, w]). Lane s owns the entries
    [s * m/S, (s+1) * m/S). ``state``, such a stacked tuple, resumes every
    row from its carried cache: read at entry and written back in place
    (each walk reads and writes only its own row)."""
    code = _agg(agg)
    m = keys.shape[0]
    if shards < 1 or m % shards:
        raise ValueError(f"stream length {m} is not a multiple of "
                         f"shards={shards}")
    if d < 1 or w < 1:
        raise ValueError(f"a cache needs d, w >= 1, got {d}, {w}")
    if values.shape != (m,) or (valid is not None and valid.shape != (m,)):
        raise ValueError("keys, values and valid must have one length")
    n = m // shards
    if state is not None:
        want = (torch.uint32, torch.float32, torch.bool)
        if len(state) != 3 or any(
                t.dtype != dt or tuple(t.shape) != (shards, d, w)
                or t.device != keys.device or not t.is_contiguous()
                for t, dt in zip(state, want)):
            raise ValueError(f"a carried GROUP BY cache is (keys uint32, "
                             f"aggs f32, valid bool), each [{shards}, {d}, "
                             f"{w}], on {keys.device}")
    if not keys.is_cuda:
        ev, st = groupby_pass1_plain(
            keys.reshape(shards, n), values.reshape(shards, n),
            None if valid is None else valid.reshape(shards, n), d=d, w=w,
            agg=agg, seed=seed, state=state)
        return tuple(e.reshape(m) for e in ev), st
    k, skey, hittable = key_form(keys)
    # a float key stores another key than it is hashed by, and may hit no
    # slot: the walk reads both by the entry's index
    skey, nohit = ((wrap_i32(skey).view(torch.uint32), ~hittable)
                   if keys.is_floating_point() else (None, None))
    check_cuda("keys", k, torch.uint32)
    check_cuda("values", values, torch.float32, keys.device)
    if valid is not None:
        check_cuda("valid", valid, torch.bool, keys.device)
    check_rowpar(m, w, 9)
    dev = keys.device
    ev_k = torch.empty(m, dtype=torch.int32, device=dev).view(torch.uint32)
    ev_a = torch.empty(m, dtype=torch.float32, device=dev)
    ev_v = torch.empty(m, dtype=torch.bool, device=dev)
    st = init_state(shards, d, w, agg, dev) if state is None else state
    if m:
        work = workspace(dev, "groupby_pass1_workspace", shards, n, d)
        GROUPBY_PASS1.launch(dev, ptr(k), ptr(values),
                             None if valid is None else ptr(valid), ptr(ev_k),
                             ptr(ev_a), ptr(ev_v), *(ptr(s) for s in st),
                             shards, n, d, w, code, seed & 0xFFFFFFFF,
                             None if skey is None else ptr(skey),
                             None if nohit is None else ptr(nohit),
                             int(state is not None), ptr(work))
    return (ev_k, ev_a, ev_v), st
