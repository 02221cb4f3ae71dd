"""Query-batched pass 1: the row-parallel walks of TOP-N rand, DISTINCT and
GROUP BY over one stream for a wave of queries, in one launch.

``core.batched`` runs Q queries of one family as one program, every shape
parameter padded to the batch's cap (``dcap``, ``wcap``) and every value
parameter per query (d, w, seed). Each wrapper here takes the stream's S
lanes and the wave's per-query (d, w, seed), and returns the keep masks
[Q, m] and the states padded to the batch's caps, [Q, S, dcap, wcap], with
the pads the JAX package's batched bodies hold
(``src/repro/core/batched.py``): a TOP-N row's slots past w and its rows
past d are NEG; a DISTINCT slot past w is 0 and never valid (head 0); a
GROUP BY slot past w is (0, init, invalid). GROUP BY's emissions are
[Q, m].

On a card each is one launch for up to ``MAX_Q`` queries (a larger wave
takes several): the query-axis partition of ``csrc/rowpar.cuh``
(``rowpar_partition_q``: each entry loaded once and hashed once for each
query, segment g = segbase[q] + lane * d[q] + row), then one warp a
(query, lane, row) segment walking its entries with its query's w, into
the padded state (``topn_walk_q`` in ``topn.cu``; ``distinct_walk_q`` in
``distinct.cu``, after the serial walk's drop of repeats, query by query;
``groupby_walk_q`` in ``groupby.cu``, after the serial walk's run marks).
The batched walks share each serial walk's segment body. A batched walk
takes rows of at most 32 slots (``wcap <= 32``, ``BATCH_MAX_W``); the
caller (``core.batched``) runs a wider batch through the serial kernels,
query by query. A kernel that fails to build or launch raises. On the CPU
each wrapper runs its plain version: the loop over the wave of the serial
plain pass 1, each result padded to the caps.
"""
from __future__ import annotations

import ctypes

import torch

from ..constants import NEG
from .common import (I32, P, CudaKernel, LaunchCount, check_cuda, check_rowpar,
                     library_fn, ptr)
from .groupby_scan import INIT, _agg, groupby_pass1_plain, key_form
from .cms_sketch import wrap_i32
from . import ref

TOPN_PASS1_BATCH = CudaKernel(
    "topn_pass1_batch", [P, P, P, I32, I32, I32, P, P, P, I32, I32, P])
DISTINCT_PASS1_BATCH = CudaKernel(
    "distinct_pass1_batch",
    [P, P, P, P, P, I32, I32, I32, P, P, P, I32, I32, I32, I32, P])
# the LRU policy of the batched DISTINCT walk, counted apart
DISTINCT_PASS1_BATCH_LRU = LaunchCount("distinct_pass1_batch_lru")
GROUPBY_PASS1_BATCH = CudaKernel(
    "groupby_pass1_batch",
    [P, P, P, P, P, P, P, P, P, I32, I32, I32, P, P, P, I32, I32, I32, P, P,
     P])
BATCH_KERNELS = (TOPN_PASS1_BATCH, DISTINCT_PASS1_BATCH,
                 DISTINCT_PASS1_BATCH_LRU, GROUPBY_PASS1_BATCH)
MAX_Q = 16        # queries a launch (ROWPAR_MAX_Q of csrc/rowpar.cuh)
BATCH_MAX_W = 32  # the batched walks keep a row in registers


def _check_wave(m: int, shards: int, d, w, seeds, dcap: int, wcap: int
                ) -> int:
    if not len(d) == len(w) == len(seeds) or not d:
        raise ValueError("a wave needs one (d, w, seed) per query, and one "
                         "query at least")
    if shards < 1 or m % shards:
        raise ValueError(f"stream length {m} is not a multiple of "
                         f"shards={shards}")
    for dq, wq in zip(d, w):
        if not (1 <= dq <= dcap and 1 <= wq <= wcap):
            raise ValueError(f"a query's d={dq}, w={wq} must lie in "
                             f"[1, dcap={dcap}] and [1, wcap={wcap}]")
    return m // shards


def _waves(nq: int, m: int):
    """Query ranges of one launch each: at most MAX_Q queries, and fewer
    than 2^31 partitioned entries (the walks index them in int32)."""
    per = max(1, min(MAX_Q, ((1 << 31) - 1) // max(m, 1)))
    return [(q, min(nq, q + per)) for q in range(0, nq, per)]


def _host_ints(vals, ctype=ctypes.c_int):
    arr = (ctype * len(vals))(*vals)
    return arr, ctypes.addressof(arr)


def _workspace(device: torch.device, nq: int, shards: int, shard_len: int,
               d, entry_bytes: int | None = None) -> torch.Tensor:
    """Scratch of one launch: ``rowpar_batch_workspace`` for a walk that
    partitions entries of ``entry_bytes``, else DISTINCT's own (its
    compaction)."""
    _arr, addr = _host_ints(d)  # alive until the call returns
    if entry_bytes is None:
        nbytes = int(library_fn("distinct_pass1_batch_workspace",
                                [I32, I32, I32, P], ctypes.c_size_t)(
            nq, shards, shard_len, addr))
    else:
        nbytes = int(library_fn("rowpar_batch_workspace",
                                [I32, I32, I32, P, I32], ctypes.c_size_t)(
            nq, shards, shard_len, addr, entry_bytes))
    if not nbytes:
        raise ValueError(f"the batched walks take 1 to {MAX_Q} queries a "
                         f"launch, got {nq}")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _launch_wave(kernel: CudaKernel, device, lo: int, hi: int, d, w, seeds,
                 front: tuple, back: tuple, *, count=None) -> None:
    """One launch for queries [lo, hi): the per-query host arrays go
    between ``front`` (pointers and the lane layout) and ``back``."""
    # the host arrays stay alive until the launch returns
    _d, da = _host_ints(d[lo:hi])
    _w, wa = _host_ints(w[lo:hi])
    _s, sa = _host_ints([s & 0xFFFFFFFF for s in seeds[lo:hi]],
                        ctypes.c_uint32)
    kernel.launch(device, *front, da, wa, sa, *back, count=count)


# ======================================================= TOP-N (rand, Ex. 7)
def topn_pass1_batch_plain(values: torch.Tensor, *, d, w, seeds, shards: int,
                           dcap: int, wcap: int):
    """The loop of the reference's batched TOP-N body over the wave: each
    query's B = 1 scan of the S lanes (``ref.topn_block_ref``, the engine's
    family), its matrix padded with NEG."""
    m = values.shape[0]
    n = _check_wave(m, shards, d, w, seeds, dcap, wcap)
    keep = torch.empty((len(d), m), dtype=torch.bool, device=values.device)
    st = torch.full((len(d), shards, dcap, wcap), float(NEG),
                    dtype=torch.float32, device=values.device)
    for q, (dq, wq, sq) in enumerate(zip(d, w, seeds)):
        k, s = ref.topn_block_ref(values.reshape(shards, n), d=dq, w=wq,
                                  block=1, seed=sq, return_state=True)
        keep[q] = k.reshape(m)
        st[q, :, :dq, :wq] = s
    return keep, st


def topn_pass1_batch(values: torch.Tensor, *, d, w, seeds, shards: int,
                     dcap: int, wcap: int):
    """TOP-N pass 1 (B = 1, the engine's family) of a wave: keep bool[Q, m]
    and matrices f32[Q, S, dcap, wcap]; lane s hashes its shard-local index
    with each query's d and seed."""
    m = values.shape[0]
    n = _check_wave(m, shards, d, w, seeds, dcap, wcap)
    if not values.is_cuda:
        return topn_pass1_batch_plain(values, d=d, w=w, seeds=seeds,
                                      shards=shards, dcap=dcap, wcap=wcap)
    check_cuda("values", values, torch.float32)
    check_rowpar(m, wcap, 4)
    if wcap > BATCH_MAX_W:
        raise ValueError(f"the batched walk takes wcap <= {BATCH_MAX_W}, "
                         f"got {wcap}")
    dev = values.device
    keep = torch.empty((len(d), m), dtype=torch.bool, device=dev)
    st = torch.full((len(d), shards, dcap, wcap), float(NEG),
                    dtype=torch.float32, device=dev)
    if m:
        for lo, hi in _waves(len(d), m):
            work = _workspace(dev, hi - lo, shards, n, d[lo:hi], 8)
            _launch_wave(TOPN_PASS1_BATCH, dev, lo, hi, d, w, seeds,
                         (ptr(values), ptr(keep[lo]), ptr(st[lo]), hi - lo,
                          shards, n), (dcap, wcap, ptr(work)))
    return keep, st


# ============================================== DISTINCT (FIFO / LRU, Ex. 2)
def _distinct_pads(nq: int, shards: int, dcap: int, wcap: int, device):
    return (torch.zeros((nq, shards, dcap, wcap), dtype=torch.int32,
                        device=device).view(torch.uint32),
            torch.zeros((nq, shards, dcap, wcap), dtype=torch.bool,
                        device=device),
            torch.zeros((nq, shards, dcap), dtype=torch.int32,
                        device=device))


def distinct_pass1_batch_plain(values: torch.Tensor, *, d, w, seeds,
                               shards: int, dcap: int, wcap: int,
                               policy: str = "lru"):
    """The loop of the reference's batched DISTINCT body over the wave: each
    query's B = 1 scan (``ref.distinct_lru_ref`` or the FIFO block oracle
    at B = 1), its cache padded with never-valid zero slots."""
    m = values.shape[0]
    n = _check_wave(m, shards, d, w, seeds, dcap, wcap)
    keep = torch.empty((len(d), m), dtype=torch.bool, device=values.device)
    slots, valid, head = _distinct_pads(len(d), shards, dcap, wcap,
                                        values.device)
    lanes = values.reshape(shards, n)
    for q, (dq, wq, sq) in enumerate(zip(d, w, seeds)):
        k, (s, v, h) = (
            ref.distinct_lru_ref(lanes, d=dq, w=wq, seed=sq,
                                 return_state=True) if policy == "lru"
            else ref.distinct_block_ref(lanes, d=dq, w=wq, block=1, seed=sq,
                                        return_state=True))
        keep[q] = k.reshape(m)
        slots[q, :, :dq, :wq] = s
        valid[q, :, :dq, :wq] = v
        head[q, :, :dq] = h
    return keep, slots, valid, head


def distinct_pass1_batch(values: torch.Tensor, *, d, w, seeds, shards: int,
                         dcap: int, wcap: int, policy: str = "lru"):
    """DISTINCT pass 1 (B = 1, FIFO or LRU) of a wave over a uint32 or
    float32 stream (``parallel.distinct_form``): keep bool[Q, m], slots
    uint32 and valid bool [Q, S, dcap, wcap], head int32 [Q, S, dcap]."""
    if policy not in ("lru", "fifo"):
        raise ValueError(f"policy must be 'lru' or 'fifo', got {policy!r}")
    m = values.shape[0]
    n = _check_wave(m, shards, d, w, seeds, dcap, wcap)
    if not values.is_cuda:
        return distinct_pass1_batch_plain(values, d=d, w=w, seeds=seeds,
                                          shards=shards, dcap=dcap,
                                          wcap=wcap, policy=policy)
    if values.dtype not in (torch.uint32, torch.float32):
        raise TypeError(f"values must be uint32 or float32, got "
                        f"{values.dtype}")
    check_cuda("values", values, values.dtype)
    check_rowpar(m, wcap, 5)
    if wcap > BATCH_MAX_W:
        raise ValueError(f"the batched walk takes wcap <= {BATCH_MAX_W}, "
                         f"got {wcap}")
    dev = values.device
    keep = torch.empty((len(d), m), dtype=torch.bool, device=dev)
    slots, valid, head = _distinct_pads(len(d), shards, dcap, wcap, dev)
    lru = policy == "lru"
    if m:
        for lo, hi in _waves(len(d), m):
            work = _workspace(dev, hi - lo, shards, n, d[lo:hi])
            _launch_wave(
                DISTINCT_PASS1_BATCH, dev, lo, hi, d, w, seeds,
                (ptr(values), ptr(keep[lo]), ptr(slots[lo]), ptr(valid[lo]),
                 ptr(head[lo]), hi - lo, shards, n),
                (dcap, wcap, int(lru), int(values.dtype == torch.float32),
                 ptr(work)), count=DISTINCT_PASS1_BATCH_LRU if lru else None)
    return keep, slots, valid, head


# ========================================================= GROUP BY (§4.2)
def _groupby_pads(nq: int, shards: int, dcap: int, wcap: int, agg: str,
                  device):
    shape = (nq, shards, dcap, wcap)
    return (torch.zeros(shape, dtype=torch.int32,
                        device=device).view(torch.uint32),
            torch.full(shape, INIT[agg], dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.bool, device=device))


def groupby_pass1_batch_plain(keys: torch.Tensor, values: torch.Tensor,
                              valid: torch.Tensor | None, *, d, w, seeds,
                              agg: str, shards: int, dcap: int, wcap: int):
    """The loop of the reference's batched GROUP BY body over the wave:
    each query's scan (``groupby_scan.groupby_pass1_plain``), its cache
    padded with (0, init, invalid) slots."""
    m = keys.shape[0]
    n = _check_wave(m, shards, d, w, seeds, dcap, wcap)
    dev = keys.device
    ev = (torch.empty((len(d), m), dtype=torch.int32,
                      device=dev).view(torch.uint32),
          torch.empty((len(d), m), dtype=torch.float32, device=dev),
          torch.empty((len(d), m), dtype=torch.bool, device=dev))
    st = _groupby_pads(len(d), shards, dcap, wcap, agg, dev)
    for q, (dq, wq, sq) in enumerate(zip(d, w, seeds)):
        e, s = groupby_pass1_plain(
            keys.reshape(shards, n), values.reshape(shards, n),
            None if valid is None else valid.reshape(shards, n), d=dq, w=wq,
            agg=agg, seed=sq)
        for out, x in zip(ev, e):
            out[q] = x.reshape(m)
        for out, x in zip(st, s):
            out[q, :, :dq, :wq] = x
    return ev, st


def groupby_pass1_batch(keys: torch.Tensor, values: torch.Tensor,
                        valid: torch.Tensor | None = None, *, d, w, seeds,
                        agg: str = "sum", shards: int = 1, dcap: int,
                        wcap: int):
    """GROUP BY pass 1 of a wave over keys (``groupby_scan.key_form``) and
    f32 values: ((ev_k uint32, ev_a f32, ev_valid bool) each [Q, m],
    (keys uint32, aggs f32, valid bool) each [Q, S, dcap, wcap])."""
    code = _agg(agg)
    m = keys.shape[0]
    n = _check_wave(m, shards, d, w, seeds, dcap, wcap)
    if values.shape != (m,) or (valid is not None and valid.shape != (m,)):
        raise ValueError("keys, values and valid must have one length")
    if not keys.is_cuda:
        return groupby_pass1_batch_plain(keys, values, valid, d=d, w=w,
                                         seeds=seeds, agg=agg, shards=shards,
                                         dcap=dcap, wcap=wcap)
    k, skey, hittable = key_form(keys)
    skey, nohit = ((wrap_i32(skey).view(torch.uint32), ~hittable)
                   if keys.is_floating_point() else (None, None))
    check_cuda("keys", k, torch.uint32)
    check_cuda("values", values, torch.float32, keys.device)
    if valid is not None:
        check_cuda("valid", valid, torch.bool, keys.device)
    check_rowpar(m, wcap, 9)
    if wcap > BATCH_MAX_W:
        raise ValueError(f"the batched walk takes wcap <= {BATCH_MAX_W}, "
                         f"got {wcap}")
    dev = keys.device
    ev = (torch.empty((len(d), m), dtype=torch.int32,
                      device=dev).view(torch.uint32),
          torch.empty((len(d), m), dtype=torch.float32, device=dev),
          torch.empty((len(d), m), dtype=torch.bool, device=dev))
    st = _groupby_pads(len(d), shards, dcap, wcap, agg, dev)
    if m:
        for lo, hi in _waves(len(d), m):
            work = _workspace(dev, hi - lo, shards, n, d[lo:hi], 16)
            _launch_wave(
                GROUPBY_PASS1_BATCH, dev, lo, hi, d, w, seeds,
                (ptr(k), ptr(values), None if valid is None else ptr(valid),
                 *(ptr(e[lo]) for e in ev), *(ptr(s[lo]) for s in st),
                 hi - lo, shards, n),
                (dcap, wcap, code, None if skey is None else ptr(skey),
                 None if nohit is None else ptr(nohit), ptr(work)))
    return ev, st
