"""Batched (multi-query) pruning bodies: Q queries of one family, one
program (paper §6: the switch serves many concurrent queries over one
entry stream).

``engine_prune_batch`` (``core.batch_engine``) packs Q same-family queries
so that they share the stream's lanes. This module holds each family's
bodies, as the JAX package's ``core/batched.py`` defines them: every
*shape* parameter (w, d, the sketch's rows and width) is padded to the
batch's cap, and every *value* parameter (N, threshold, seed, the
effective widths) is the query's own. The contract is bit-identity with
the reference's batched bodies (keep, state and emitted), and so with a
serial ``engine_prune`` of each query's keep. The pads are the
reference's:

- TOP-N det: levels past a query's w count but never qualify, so the
  ladder's threshold is the serial one (the scan's state holds the counts
  of every level of the cap).
- TOP-N rand: matrix columns past w and rows past d are NEG; the keep test
  reads column w - 1; the merge re-pins the columns past w to NEG.
- DISTINCT: slots past w are 0 and never valid, so they never hit.
- SKYLINE: slots past w hold (0, NEG), as the serial state's empty slots.
- GROUP BY: slots past w hold (0, init, invalid); emissions keep the full
  padded length of every query.
- HAVING: sketch rows past the query's rows are +0 and read as the dtype's
  maximum in the minimum; every row of the table reads a sum of -0 as +0
  (the batched build adds each row into a table of +0 eagerly, where the
  serial jitted body drops that add in rows 0 and 1: ROADMAP Queue 3
  Part B); thresholds are int32 unless one of the batch is a float, and
  then all compare in f32 (``_num``).

The hash's side of 2^16 (multiply-shift or modulo) and the family statics
(policy, score, agg) must agree across a batch (``_uniform``,
``_small_mod``): ``query.run_queries`` groups by them.

Each family's ``pass1`` takes a wave's queries at once. TOP-N rand,
DISTINCT and GROUP BY, whose pass 1 is the row-parallel walk, run the
query-batched walks of ``kernels.batch_walks`` (one launch for up to 16
queries, rows of at most 32 slots; a wider batch runs the serial kernels
query by query). TOP-N det, SKYLINE and HAVING run their serial pass-1
kernels once for each query into the batch's padded state, and every
merge and pass 2 runs once for each query.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from ..constants import NEG
from ..kernels import parallel as kpar
from ..kernels.batch_walks import (BATCH_MAX_W, distinct_pass1_batch,
                                   groupby_pass1_batch, topn_pass1_batch)
from ..kernels.cms_sketch import (INT_TABLES, by_value_i64, cms_build_kernel,
                                  cms_query_kernel)
from ..kernels.common import flush_subnormals
from ..kernels.groupby_scan import INIT, groupby_pass1_kernel
from ..kernels.topn_det_scan import topn_det_pass1_kernel
from . import engine as E
from .distinct import DistinctState
from .groupby import GroupByState
from .hashing import by_value
from .sketches import CountMin, plus_zero_rows
from .skyline import SkylineState
from .topn import TopNDetState, TopNRandState


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """How the batched engine runs one algorithm family.

    build(queries)                       -> (qps, caps): one dict of value
        params a query, and the batch's caps (shape params at their
        maximum) and family statics; build checks that the statics agree.
    pass1(lanes, qps, caps, full)        -> (keep bool[Q, S, n], the
        stacked lane states [Q, S, ...], emitted [Q, S, n] each or None).
        ``full``: the scan's state is the result (else only the merge
        reads it).
    merge(state_q, q, caps)              -> one query's merged state
    apply(merged_q, lanes, keep1_q, q, caps) -> keep bool[S, n]
    state_bytes(caps, streams)           -> one lane's padded state bytes;
        ``streams``: (dtype, trailing shape) of each decoded stream.
    chunkable mirrors the serial spec's flag.
    """

    build: Callable[[list], tuple[list, dict]]
    pass1: Callable[[tuple, list, dict, bool], tuple]
    merge: Callable[[Any, dict, dict], Any]
    apply: Callable[[Any, tuple, torch.Tensor, dict, dict], torch.Tensor]
    state_bytes: Callable[[dict, list], int]
    chunkable: bool = False


def _uniform(queries: list, key: str, default, algo: str):
    vals = {q.get(key, default) for q in queries}
    if len(vals) > 1:
        raise ValueError(
            f"engine_prune_batch({algo!r}): {key} must agree across the "
            f"batch (got {sorted(map(str, vals))}); group by it first "
            f"(query.run_queries does)")
    return vals.pop()


def _small_mod(queries: list, key: str, algo: str) -> bool:
    smalls = {int(q[key]) < (1 << 16) for q in queries}
    if len(smalls) > 1:
        raise ValueError(
            f"engine_prune_batch({algo!r}): hash_mod's multiply-shift vs "
            f"modulo branch is static, so all {key} must sit on the same "
            f"side of 2^16; split the batch (query.run_queries groups by "
            f"this)")
    return smalls.pop()


def _num(vals) -> tuple[list, bool]:
    """The thresholds as the reference's per-query column holds them: int32
    (wrapped) when every one is an integer, else float32 for all."""
    a = np.asarray(vals)
    if np.issubdtype(a.dtype, np.integer):
        return [int(v) for v in a.astype(np.int32)], True
    return [float(v) for v in a.astype(np.float32)], False


def stack(states: list, join=torch.stack):
    """Per-query states (a dataclass of tensors, a tensor or a tuple of
    tensors) stacked along a new leading axis (``join=torch.cat``: waves
    of them joined along it)."""
    s0 = states[0]
    if isinstance(s0, torch.Tensor):
        return join(states)
    if isinstance(s0, tuple):
        return tuple(join(x) for x in zip(*states))
    return dataclasses.replace(s0, **{
        f.name: join([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(s0)
        if isinstance(getattr(s0, f.name), torch.Tensor)})


def take(state, i):
    """Entry i along the leading axis of a stacked state (``stack``)."""
    if state is None:
        return None
    if isinstance(state, torch.Tensor):
        return state[i]
    if isinstance(state, tuple):
        return tuple(x[i] for x in state)
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[i] for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def _pad_to(t: torch.Tensor, shape: tuple, fill) -> torch.Tensor:
    """``t`` in the corner of a tensor of ``shape`` filled with ``fill``."""
    out = torch.full(shape, fill, dtype=t.dtype, device=t.device) \
        if t.dtype != torch.uint32 else torch.full(
            shape, fill, dtype=torch.int32, device=t.device).view(torch.uint32)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _walk_lists(qps: list):
    """(d, w, seed) lists of a wave, as the batched walks take them."""
    return ([q["d"] for q in qps], [q["w"] for q in qps],
            [q["seed"] for q in qps])


# ---------------------------------------------------- TOP-N deterministic
def _topn_det_build(queries):
    caps = {"w": max(int(q.get("w", 4)) for q in queries)}
    qps = [{"N": int(q["N"]), "w": int(q.get("w", 4))} for q in queries]
    return qps, caps


def _topn_det_pass1(lanes, qps, caps, full):
    (x,) = lanes
    S, n = x.shape
    flat = x.reshape(-1).to(torch.float32).contiguous()
    wc = caps["w"]
    keeps, st = [], []
    for q in qps:
        keep, (t0, counts, seen, cur) = topn_det_pass1_kernel(
            flat, N=q["N"], w=q["w"], shards=S)
        if q["w"] < wc:
            # a level past w counts, but never qualifies: the counts of
            # every level of the cap are the ladder's at w = cap
            counts = (topn_det_pass1_kernel(flat, N=q["N"], w=wc,
                                            shards=S)[1][1] if full
                      else _pad_to(counts, (S, wc), 0))
        keeps.append(keep.reshape(S, n))
        st.append(TopNDetState(t0=t0, counts=counts, seen=seen,
                               cur_level=cur))
    return torch.stack(keeps), stack(st), None


def _topn_det_merge(st, q, caps):
    return E._topn_det_merge(st, {"w": caps["w"]})


def _topn_det_apply(merged, lanes, keep1, q, caps):
    return E._topn_det_apply(merged, lanes, keep1, q)


def _topn_det_bytes(caps, streams):
    return 4 * (3 + caps["w"])


# ------------------------------------------------------ TOP-N randomized
def _topn_rand_build(queries):
    caps = {"d": max(int(q["d"]) for q in queries),
            "w": max(int(q["w"]) for q in queries),
            "small": _small_mod(queries, "d", "topn_rand")}
    qps = [{"d": int(q["d"]), "w": int(q["w"]),
            "seed": int(q.get("seed", 0)) & 0xFFFFFFFF} for q in queries]
    return qps, caps


def _topn_rand_pass1(lanes, qps, caps, full):
    (x,) = lanes
    S, n = x.shape
    flat = x.reshape(-1).to(torch.float32).contiguous()
    dc, wc = caps["d"], caps["w"]
    if wc <= BATCH_MAX_W:
        d, w, seeds = _walk_lists(qps)
        keep, vals = topn_pass1_batch(flat, d=d, w=w, seeds=seeds, shards=S,
                                      dcap=dc, wcap=wc)
        return keep.reshape(len(qps), S, n), TopNRandState(vals=vals), None
    keeps, vals = [], []
    for q in qps:
        k, v = kpar.topn_shard_states_kernel(
            flat, d=q["d"], w=q["w"], shards=S, block=1, seed=q["seed"],
            family="engine")
        keeps.append(k.reshape(S, n))
        vals.append(_pad_to(v, (S, dc, wc), float(NEG)))
    return torch.stack(keeps), TopNRandState(vals=torch.stack(vals)), None


def _topn_rand_merge(st, q, caps):
    merged = kpar.merge_topn_states(st.vals, caps["w"])
    merged[:, q["w"]:] = float(NEG)
    return TopNRandState(vals=merged)


def _topn_rand_apply(merged, lanes, keep1, q, caps):
    (x,) = lanes
    keep = kpar.topn_apply_kernel(
        x.reshape(-1).to(torch.float32).contiguous(),
        merged.vals[:q["d"], :q["w"]].contiguous(), d=q["d"],
        shards=x.shape[0], seed=q["seed"], family="engine")
    return keep.reshape(x.shape)


def _topn_rand_bytes(caps, streams):
    return 4 * caps["d"] * caps["w"]


# -------------------------------------------------------------- DISTINCT
def _distinct_build(queries):
    caps = {"d": max(int(q["d"]) for q in queries),
            "w": max(int(q["w"]) for q in queries),
            "policy": _uniform(queries, "policy", "lru", "distinct"),
            "small": _small_mod(queries, "d", "distinct")}
    qps = [{"d": int(q["d"]), "w": int(q["w"]),
            "seed": int(q.get("seed", 0)) & 0xFFFFFFFF} for q in queries]
    return qps, caps


def _distinct_pass1(lanes, qps, caps, full):
    (x,) = lanes
    S, n = x.shape
    values = kpar.distinct_form(x.reshape(-1))
    dc, wc = caps["d"], caps["w"]
    if wc <= BATCH_MAX_W:
        d, w, seeds = _walk_lists(qps)
        keep, slots, valid, head = distinct_pass1_batch(
            values, d=d, w=w, seeds=seeds, shards=S, dcap=dc, wcap=wc,
            policy=caps["policy"])
        return (keep.reshape(len(qps), S, n),
                DistinctState(slots, valid, head), None)
    keeps, st = [], []
    for q in qps:
        k, s, v, h = kpar.distinct_shard_states_kernel(
            values, d=q["d"], w=q["w"], shards=S, block=1, seed=q["seed"],
            policy=caps["policy"])
        keeps.append(k.reshape(S, n))
        st.append(DistinctState(_pad_to(s, (S, dc, wc), 0),
                                _pad_to(v, (S, dc, wc), False),
                                _pad_to(h, (S, dc), 0)))
    return torch.stack(keeps), stack(st), None


def _distinct_merge(st, q, caps):
    slots, valid = kpar.merge_distinct_states(st.slots, st.valid)
    return E.DistinctMerged(slots=slots, valid=valid, w=caps["w"])


def _distinct_apply(merged, lanes, keep1, q, caps):
    (x,) = lanes
    keep = kpar.distinct_apply_kernel(
        kpar.distinct_form(x.reshape(-1)), keep1.reshape(-1),
        merged.slots[:q["d"]].contiguous(), merged.valid[:q["d"]].contiguous(),
        d=q["d"], shards=x.shape[0], seed=q["seed"],
        lane0=q.get("_lane0", 0), w=merged.w)
    return keep.reshape(x.shape)


def _distinct_bytes(caps, streams):
    return caps["d"] * caps["w"] * 5 + caps["d"] * 4


# --------------------------------------------------------------- SKYLINE
def _skyline_build(queries):
    caps = {"w": max(int(q["w"]) for q in queries),
            "score": _uniform(queries, "score", "aph", "skyline")}
    qps = [{"w": int(q["w"])} for q in queries]
    return qps, caps


def _skyline_pass1(lanes, qps, caps, full):
    (x,) = lanes
    S, n, D = x.shape
    pts = E._skyline_points(x)
    wc = caps["w"]
    keeps, st = [], []
    for q in qps:
        k, p, s = kpar.skyline_shard_states_kernel(
            pts, w=q["w"], shards=S, block=1, score=caps["score"],
            form="engine")
        keeps.append(k.reshape(S, n))
        st.append(SkylineState(points=_pad_to(p, (S, wc, D), 0.0),
                               scores=_pad_to(s, (S, wc), float(NEG))))
    return torch.stack(keeps), stack(st), None


def _skyline_merge(st, q, caps):
    return E._skyline_merge(st, {})


def _skyline_apply(merged, lanes, keep1, q, caps):
    return E._skyline_apply(merged, lanes, keep1, {})


def _skyline_bytes(caps, streams):
    dims = streams[0][1]
    D = int(dims[0]) if dims else 1
    return 4 * caps["w"] * (D + 1)


# -------------------------------------------------------------- GROUP BY
def _groupby_build(queries):
    caps = {"d": max(int(q["d"]) for q in queries),
            "w": max(int(q["w"]) for q in queries),
            "agg": _uniform(queries, "agg", "sum", "groupby"),
            "small": _small_mod(queries, "d", "groupby")}
    qps = [{"d": int(q["d"]), "w": int(q["w"]),
            "seed": int(q.get("seed", 0)) & 0xFFFFFFFF} for q in queries]
    return qps, caps


def _groupby_pass1(lanes, qps, caps, full):
    keys, vals = lanes[0], lanes[1]
    S, n = keys.shape
    valid = lanes[2].reshape(-1).contiguous() if len(lanes) > 2 else None
    k = keys.reshape(-1).contiguous()
    v = by_value(vals.reshape(-1)).to(torch.float32).contiguous()
    dc, wc, agg = caps["d"], caps["w"], caps["agg"]
    if wc <= BATCH_MAX_W:
        d, w, seeds = _walk_lists(qps)
        ev, st = groupby_pass1_batch(k, v, valid, d=d, w=w, seeds=seeds,
                                     agg=agg, shards=S, dcap=dc, wcap=wc)
    else:
        evs, sts = [], []
        for q in qps:
            e, s = groupby_pass1_kernel(k, v, valid, d=q["d"], w=q["w"],
                                        agg=agg, seed=q["seed"], shards=S)
            evs.append(e)
            sts.append(tuple(_pad_to(t, (S, dc, wc), f) for t, f in
                             zip(s, (0, INIT[agg], False))))
        ev, st = stack(evs), stack(sts)
    keep = torch.zeros((len(qps), S, n), dtype=torch.bool,
                       device=keys.device)
    return (keep, GroupByState(*st),
            tuple(e.reshape(len(qps), S, n) for e in ev))


def _groupby_merge(st, q, caps):
    return GroupByState(*(kpar.cols_by_shard(x)
                          for x in (st.keys, st.aggs, st.valid)))


def _groupby_apply(merged, lanes, keep1, q, caps):
    return keep1  # all-False: every entry is absorbed into switch state


def _groupby_bytes(caps, streams):
    return caps["d"] * caps["w"] * 9


# ---------------------------------------------------------------- HAVING
def _having_build(queries):
    caps = {"rows": max(int(q.get("rows", 3)) for q in queries),
            "width": max(int(q.get("width", 1024)) for q in queries),
            "agg": _uniform(queries, "agg", "sum", "having")}
    thr, caps["thr_int"] = _num([q["threshold"] for q in queries])
    qps = [{"rows": int(q.get("rows", 3)), "width": int(q.get("width", 1024)),
            "seed": int(q.get("seed", 0)) & 0xFFFFFFFF, "threshold": t}
           for q, t in zip(queries, thr)]
    return qps, caps


def _weights(lanes, caps):
    if caps["agg"] == "count" or len(lanes) < 2:
        return None
    return lanes[1].reshape(-1).contiguous()


def _having_keep(table, keys, q, caps):
    """keep = est > threshold of the query's rows and width of ``table``,
    as the batched reference compares: the rows past the query's read as
    the dtype's maximum (an estimate of +inf reads the finite maximum
    then), and the threshold column's dtype (int32, or f32 for all)
    promotes with the table's as JAX promotes them."""
    t = table[:q["rows"], :q["width"]].contiguous()
    thr, thr_int = q["threshold"], caps["thr_int"]
    if t.dtype == torch.int32 and thr_int:
        return cms_query_kernel(t, keys, seed=q["seed"], family="engine",
                                threshold=thr)
    est = cms_query_kernel(t, keys, seed=q["seed"], family="engine")
    if t.dtype in INT_TABLES:
        if thr_int:
            return by_value_i64(est) > thr
        return by_value_i64(est).to(torch.float32) > flush_subnormals(
            torch.tensor(thr, dtype=torch.float32, device=est.device))
    if q["rows"] < caps["rows"]:
        est = torch.where(est == math.inf, torch.finfo(est.dtype).max, est)
    # an int32 column promotes into the table's float dtype, an f32 one
    # takes f32
    cmp = est.dtype if thr_int else torch.float32
    e = est.to(cmp)
    th = torch.tensor(thr, dtype=cmp, device=est.device)
    if cmp == torch.float32:
        e, th = flush_subnormals(e), flush_subnormals(th)
    return e > th


def _having_pass1(lanes, qps, caps, full):
    keys = lanes[0]
    S, n = keys.shape
    flat = keys.reshape(-1).contiguous()
    weights = _weights(lanes, caps)
    rc, wc = caps["rows"], caps["width"]
    keeps, tables = [], []
    for q in qps:
        t = cms_build_kernel(flat, weights, rows=q["rows"], width=q["width"],
                             seed=q["seed"], family="engine", shards=S)
        # every row added into a table of +0, eagerly (ROADMAP Queue 3
        # Part B: the batched build reads a sum of -0 as +0 in every row)
        table = _pad_to(plus_zero_rows(t, 0), (S, rc, wc), 0)
        tables.append(table)
        keeps.append(_having_keep(table[0], flat, q, caps).reshape(S, n)
                     if full and S == 1 else
                     torch.zeros((S, n), dtype=torch.bool,
                                 device=keys.device))
    return torch.stack(keeps), torch.stack(tables), None


def _having_merge(st, q, caps):
    return E._having_merge(CountMin(table=st, seed=q["seed"]), {}).table


def _having_apply(merged, lanes, keep1, q, caps):
    keys = lanes[0]
    return _having_keep(merged, keys.reshape(-1).contiguous(), q,
                        caps).reshape(keys.shape)


def _having_bytes(caps, streams):
    itemsize = (4 if caps["agg"] == "count" or len(streams) < 2
                else torch.empty((), dtype=streams[1][0]).element_size())
    return caps["rows"] * caps["width"] * itemsize


BSPECS: dict[str, BatchSpec] = {
    "topn_det": BatchSpec(_topn_det_build, _topn_det_pass1, _topn_det_merge,
                          _topn_det_apply, _topn_det_bytes),
    "topn_rand": BatchSpec(_topn_rand_build, _topn_rand_pass1,
                           _topn_rand_merge, _topn_rand_apply,
                           _topn_rand_bytes),
    "distinct": BatchSpec(_distinct_build, _distinct_pass1, _distinct_merge,
                          _distinct_apply, _distinct_bytes, chunkable=True),
    "skyline": BatchSpec(_skyline_build, _skyline_pass1, _skyline_merge,
                         _skyline_apply, _skyline_bytes, chunkable=True),
    "groupby": BatchSpec(_groupby_build, _groupby_pass1, _groupby_merge,
                         _groupby_apply, _groupby_bytes),
    "having": BatchSpec(_having_build, _having_pass1, _having_merge,
                        _having_apply, _having_bytes),
}
