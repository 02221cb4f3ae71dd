"""Sharded pruning engine: superset-safe parallel execution (paper §3/§7.2).

Forwarding any superset of a pruner's keep set leaves the query answer
unchanged, so S independent switch lanes over S contiguous shards of the
stream still yield a correct superset. ``engine_prune(algo, stream,
mode=..., shards=S)`` runs one of four modes on the device the stream
lives on (``mesh``: on the mesh's positions):

``scan``      one lane over the whole stream (the single-switch oracle).
``sharded``   S lanes, each over its contiguous shard; the keep masks
              concatenate.
``two_pass``  pass 1 builds the S lane states, ``merge_states`` folds them
              into one global state (per-row top-w union for TOP-N, cache
              union with owner shards for DISTINCT), and pass 2 applies
              the merged state to every entry.

On a card pass 1 is the pass-1 CUDA kernel with blocks of one entry (the
engine's per-entry semantics) and pass 2 the apply kernel; on the CPU both
are their plain versions. ``topn_det``'s pass 1 is the ladder scan kernel
(``topn_det_pass1``), its merge the max over lanes of t0 * 2^cur_level and
its pass 2 a plain compare, as in the reference. DISTINCT's LRU policy (the
default) runs the serial LRU pass-1 kernel; merge and apply are FIFO's.
HAVING's pass 1 is the Count-Min build kernel
over S lane tables and its pass 2 the fused query-and-threshold kernel;
its keep rule is global, so ``sharded`` merges and applies as ``two_pass``
does. GROUP BY's pass 1 is the ``groupby_pass1`` scan kernel; every entry is
absorbed (keep all-False), the lanes' evictions come back as
``PruneResult.emitted`` at the full padded length S * ceil(m/S) (a tail pad
can evict a real partial), and ``two_pass`` merges the caches by column
union. The parallel modes' masks are supersets of the minimal correct
survivor set, not of the scan's mask.

``encoding=`` takes dictionary-encoded streams (uint32 codes and a
``DictEncoding`` each): every pass-1 and apply body decodes its lanes with
one ``lut[code]`` gather at entry, and tail pads become codes that decode to
the plain fills, so masks are bit-identical to the decoded streams'.
``decode="eager"`` decodes up front instead.

``options=`` takes an ``ExecOptions`` bundle of the knobs, ``shards="auto"``
sizes S by the planner's T(S) = m/S + c·S·state_bytes with the merge cost
c measured once per algorithm and signature on the streams' device
(``calibrate_merge_cost``), and ``obs=`` attaches an ``ExecReport`` to the
result (counters from the materialised mask, wall-clock spans in
``"trace"`` mode); no instrument touches a kernel's input or output.
``tune="cached"`` / ``"race"`` runs a plan of the self-tuning planner
(``planner.resolve_plan``, the plan cache in ``core.plancache``) through
``execute_plan``: two_pass at the plan's S, masks identical for every
plan at that S.

``mesh``     two_pass with the S lanes spread over the positions of a
             ``core.mesh.Mesh`` (S/D lanes a position), pass 2 at the
             master (``pass2="master"``) or on each position's resident
             lanes (``pass2="mesh"``: only the lane states are gathered).

All six algorithms (``topn_det``, ``topn_rand``, ``distinct`` with
``policy="lru"`` or ``"fifo"``, ``skyline``, ``having``, ``groupby``) run
in all four modes, plain or encoded. Each algorithm's ``resume`` and
``init`` bodies carry the streaming fold (``core.streaming``): pass 1 from
a carried stacked state, in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..constants import NEG
from ..kernels import parallel as kpar
from ..kernels.cms_sketch import (INT_TABLES, by_value_i64, cms_query_kernel,
                                  wrap_to)
from ..kernels.common import amax_f32, flush_subnormals, xla_sum_f32
from ..kernels.groupby_scan import groupby_pass1_kernel
from ..kernels.ops import _pad_to, first_value
from ..kernels.topn_det_scan import pow2, topn_det_pass1_kernel
from ..obs import report as obsreport
from . import planner
from .distinct import DistinctState
from .distinct import init_state as distinct_init
from .encoding import as_x32, normalize_encodings
from .groupby import GroupByState, groupby_init
from .having import add_tables, batch_table, having_init
from .hashing import by_value
from .mesh import Mesh, default_mesh, default_positions
from .options import ExecOptions
from .pruning import PruneResult
from .skyline import SkylineState, skyline_init
from .sketches import CountMin
from .topn import TopNDetState, TopNRandState, topn_det_init, topn_rand_init

MODES = ("scan", "sharded", "two_pass", "mesh")
ALGORITHMS = ("topn_det", "topn_rand", "distinct", "skyline", "groupby",
              "having")
# pass-2 placements for mode="mesh": apply the merged state at the master
# (the whole stream), on each position's resident lanes, or let the
# planner's cost rule choose (planner.optimal_pass2)
PASS2 = ("master", "mesh", "auto")
# pass-2 chunk of mode="mesh" (and of the tuner's incumbent) for the
# chunkable algorithms, DISTINCT and SKYLINE
DEFAULT_MESH_APPLY_BLOCK = 4096


@dataclasses.dataclass
class TopNDetMerged:
    """Global TOP-N filter state: one threshold, provably query-safe.

    A lane's ladder reaches t_i only after >= N of its entries are >= t_i,
    so the N-th largest value overall is >= every lane's threshold and the
    max over lanes never drops a true top-N entry.
    """

    threshold: torch.Tensor  # f32 scalar


@dataclasses.dataclass
class DistinctMerged:
    """Union of the shard FIFO caches, with column-owner shard ids.

    Pass 2 prunes a shard-kept entry iff its value sits in a lower-ranked
    shard's final cache; column s*w + j belongs to shard s.
    """

    slots: torch.Tensor  # uint32[d, S*w]
    valid: torch.Tensor  # bool[d, S*w]
    w: int

    @property
    def shard(self) -> torch.Tensor:
        """int32[S*w]: the owner shard of each cache column (with the
        slots' leading axes, [Q, S*w] for a batch)."""
        S = self.slots.shape[-1] // self.w
        own = torch.arange(S, dtype=torch.int32,
                           device=self.slots.device).repeat_interleave(self.w)
        return own.expand(tuple(self.slots.shape[:-2]) + own.shape)


@dataclasses.dataclass(frozen=True)
class _AlgoSpec:
    """How the engine runs one pruning algorithm over S stacked lanes.

    Every body takes ``lanes``, one [S, n, ...] tensor per stream.
    pass1(lanes, params)                 -> (keep bool[S, n], stacked state,
                                             emitted: None or a tuple of
                                             [S, n] streams)
    pads(streams, params)                -> tail-pad fill of each stream
    merge(stacked_state, params)         -> merged global state
    apply(merged, lanes, keep1, params)  -> keep bool[S, n]
    resume(state, lanes, params)         -> pass1's triple, each lane's scan
                                            resumed from the stacked carried
                                            state, which it updates in place
                                            (the streaming fold; keep is
                                            None where no caller reads it)
    init(lanes, params)                  -> one lane's empty switch state on
                                            the lanes' device (the lanes are
                                            examples, read for dtypes and
                                            trailing dims)
    chunkable: the apply is elementwise over entries (no positional
    dependence), so ``apply_block`` may cut it into blocks of entries.
    sharded_needs_merge: a lane's own keep is unsafe (HAVING: a key's global
    sum can pass the threshold while every lane's estimate stays below), so
    ``sharded`` merges and applies as ``two_pass`` does.
    max_streams: how many streams the algorithm takes.
    pad_validity: a ragged m gets a validity stream (True for real entries,
    False for the tail pads) when the caller gave none, so that pads are
    inert under any aggregate (GROUP BY COUNT has no neutral pad value).
    """

    pass1: Callable[[tuple, dict], tuple]
    pads: Callable[[tuple, dict], tuple]
    merge: Callable[[Any, dict], Any]
    apply: Callable[[Any, tuple, torch.Tensor, dict], torch.Tensor]
    resume: Callable[[Any, tuple, dict], tuple]
    init: Callable[[tuple, dict], Any]
    chunkable: bool = False
    sharded_needs_merge: bool = False
    max_streams: int = 1
    pad_validity: bool = False


# TOP-N deterministic (threshold ladder, Ex. 3) --------------------------
def _topn_det_pass1(lanes, p):
    (x,) = lanes
    keep, st = topn_det_pass1_kernel(
        x.reshape(-1).to(torch.float32).contiguous(), N=p["N"],
        w=p.get("w", 4), shards=x.shape[0])
    return keep.reshape(x.shape), TopNDetState(*st), None


def _topn_det_resume(st, lanes, p):
    (x,) = lanes
    keep, _ = topn_det_pass1_kernel(
        x.reshape(-1).to(torch.float32).contiguous(), N=p["N"],
        w=p.get("w", 4), shards=x.shape[0],
        state=(st.t0, st.counts, st.seen, st.cur_level))
    return keep.reshape(x.shape), st, None


def _topn_det_init(lanes, p):
    return topn_det_init(p.get("w", 4), lanes[0].device)


def _topn_det_merge(st, p):
    # the scan's own threshold: t0 * 2^cur_level, NEG without a level
    thr = torch.where(st.cur_level >= 0,
                      st.t0 * pow2(p.get("w", 4), st.t0.device)[
                          st.cur_level.clamp(min=0)],
                      torch.tensor(float(NEG), device=st.t0.device))
    # jnp.max: +0 above -0, subnormals flushed (A25)
    return TopNDetMerged(threshold=amax_f32(thr))


def _topn_det_apply(merged, lanes, keep1, p):
    del keep1
    return (flush_subnormals(lanes[0].to(torch.float32))
            >= flush_subnormals(merged.threshold))


# TOP-N randomized (d x w rolling matrix, Ex. 7) --------------------------
def _topn_rand_pass1(lanes, p):
    (x,) = lanes
    S = x.shape[0]
    keep, vals = kpar.topn_shard_states_kernel(
        x.reshape(-1).to(torch.float32).contiguous(), d=p["d"], w=p["w"],
        shards=S, block=1, seed=p.get("seed", 0), family="engine")
    return keep.reshape(x.shape), TopNRandState(vals=vals), None


def _topn_rand_resume(st, lanes, p):
    # the row hash is positional over the lane-local stream index, so the
    # resumed scan takes the per-lane entry count consumed so far
    (x,) = lanes
    keep, _ = kpar.topn_shard_states_kernel(
        x.reshape(-1).to(torch.float32).contiguous(), d=p["d"], w=p["w"],
        shards=x.shape[0], block=1, seed=p.get("seed", 0), family="engine",
        state=st.vals, index_offset=p.get("_index_offset", 0))
    return keep.reshape(x.shape), st, None


def _topn_rand_init(lanes, p):
    return topn_rand_init(p["d"], p["w"], lanes[0].device)


def _topn_rand_merge(st, p):
    return TopNRandState(vals=kpar.merge_topn_states(st.vals, p["w"]))


def _topn_rand_apply(merged, lanes, keep1, p):
    del keep1
    (x,) = lanes
    # a streamed micro-batch's lane positions start at _index_offset
    keep = kpar.topn_apply_kernel(
        x.reshape(-1).to(torch.float32).contiguous(), merged.vals, d=p["d"],
        shards=x.shape[0], seed=p.get("seed", 0), family="engine",
        index_offset=p.get("_index_offset", 0))
    return keep.reshape(x.shape)


# DISTINCT (d x w fingerprint cache, Ex. 2) --------------------------------
def _distinct_pass1(lanes, p):
    (x,) = lanes
    S = x.shape[0]
    keep, slots, valid, head = kpar.distinct_shard_states_kernel(
        kpar.distinct_form(x.reshape(-1)), d=p["d"], w=p["w"], shards=S,
        block=1, seed=p.get("seed", 0), policy=p.get("policy", "lru"))
    return keep.reshape(x.shape), DistinctState(slots, valid, head), None


def _distinct_resume(st, lanes, p):
    (x,) = lanes
    keep, *_ = kpar.distinct_shard_states_kernel(
        kpar.distinct_form(x.reshape(-1)), d=p["d"], w=p["w"],
        shards=x.shape[0], block=1, seed=p.get("seed", 0),
        policy=p.get("policy", "lru"), state=(st.slots, st.valid, st.head))
    return keep.reshape(x.shape), st, None


def _distinct_init(lanes, p):
    return distinct_init(p["d"], p["w"], lanes[0].device)


def _distinct_merge(st, p):
    slots, valid = kpar.merge_distinct_states(st.slots, st.valid)
    return DistinctMerged(slots=slots, valid=valid, w=st.slots.shape[2])


def _distinct_apply(merged, lanes, keep1, p):
    # the "a lower-ranked shard owns it" test needs global lane ranks: a
    # resident pass 2 sees its position's lanes only, which start at
    # _lane0 of the merged union
    (x,) = lanes
    keep = kpar.distinct_apply_kernel(
        kpar.distinct_form(x.reshape(-1)), keep1.reshape(-1), merged.slots,
        merged.valid, d=p["d"], shards=x.shape[0], seed=p.get("seed", 0),
        lane0=p.get("_lane0", 0), w=merged.w)
    return keep.reshape(x.shape)


# SKYLINE (w stored points, Ex. 6) ---------------------------------------
def _skyline_points(x):
    S, n, D = x.shape
    return x.reshape(S * n, D).to(torch.float32).contiguous()


def _skyline_pass1(lanes, p):
    (x,) = lanes
    keep, pts, scs = kpar.skyline_shard_states_kernel(
        _skyline_points(x), w=p["w"], shards=x.shape[0], block=1,
        score=p.get("score", "aph"), form="engine")
    return (keep.reshape(x.shape[:2]), SkylineState(points=pts, scores=scs),
            None)


def _skyline_resume(st, lanes, p):
    (x,) = lanes
    keep, _, _ = kpar.skyline_shard_states_kernel(
        _skyline_points(x), w=p["w"], shards=x.shape[0], block=1,
        score=p.get("score", "aph"), form="engine",
        state=(st.points, st.scores))
    return keep.reshape(x.shape[:2]), st, None


def _skyline_init(lanes, p):
    return skyline_init(p["w"], lanes[0].shape[-1], lanes[0].device)


def _skyline_merge(st, p):
    S, w, D = st.points.shape
    pts = st.points.reshape(S * w, D)
    scs = st.scores.reshape(S * w)
    # keep the descending invariant (XLA's compares flush subnormals)
    order = torch.argsort(-flush_subnormals(scs), stable=True)
    return SkylineState(points=pts[order], scores=scs[order])


def _skyline_apply(merged, lanes, keep1, p):
    del keep1
    (x,) = lanes
    # a true skyline point is dominated by nothing, so it always survives
    keep = kpar.skyline_apply_kernel(_skyline_points(x), merged.points,
                                     merged.scores)
    return keep.reshape(x.shape[:2])


# HAVING (Count-Min + threshold, Ex. 5) ----------------------------------
def _having_tables(lanes, p):
    """The lanes' batch tables [S, rows, width], as the jitted reference
    builds them."""
    keys = lanes[0]
    weights = (None if p.get("agg", "sum") == "count" or len(lanes) < 2
               else lanes[1].reshape(-1))
    return batch_table(keys.reshape(-1), weights, p.get("rows", 3),
                       p.get("width", 1024), p.get("seed", 0),
                       shards=keys.shape[0])


def _having_keep(lanes, tables, p):
    # sharded_needs_merge: at S > 1 a lane's own keep is never read
    if lanes[0].shape[0] > 1:
        return None
    return cms_query_kernel(tables[0], lanes[0].reshape(-1),
                            seed=p.get("seed", 0), family="engine",
                            threshold=p["threshold"])[None]


def _having_pass1(lanes, p):
    tables = _having_tables(lanes, p)
    return (_having_keep(lanes, tables, p),
            CountMin(table=tables, seed=p.get("seed", 0)), None)


def _having_resume(st, lanes, p):
    # the batch's sketch from zero, added to the running one (state.table +
    # sketch.table, as the reference adds them)
    st.table.copy_(add_tables(st.table, _having_tables(lanes, p)))
    return _having_keep(lanes, st.table, p), st, None


def _having_init(lanes, p):
    dtype = (torch.int32 if p.get("agg", "sum") == "count" or len(lanes) < 2
             else lanes[1].dtype)
    return having_init(rows=p.get("rows", 3), width=p.get("width", 1024),
                       seed=p.get("seed", 0), dtype=dtype,
                       device=lanes[0].device)


def _having_merge(st, p):
    # sketch addition: the summed table equals one build over all lanes.
    # jnp.sum keeps int32 and uint32 (wrapping) and sums a narrower integer
    # table in the 32-bit integer of its signedness
    t = st.table
    if t.dtype in INT_TABLES:
        kind = torch.int32 if t.dtype.is_signed else torch.uint32
        summed = wrap_to(by_value_i64(t).sum(0), kind)
    elif t.dtype == torch.float32:
        # in XLA's CPU order, every add flushed (A29)
        summed = xla_sum_f32(t)
    else:
        summed = t.sum(0)
    return CountMin(table=summed, seed=st.seed)


def _having_apply(merged, lanes, keep1, p):
    del keep1
    keys = lanes[0]
    keep = cms_query_kernel(merged.table, keys.reshape(-1), seed=merged.seed,
                            family="engine", threshold=p["threshold"])
    return keep.reshape(keys.shape)


def _having_pads(streams, p):
    # pads only inflate CMS estimates; the overestimate stays one-sided.
    # Under agg="count" each pad adds 1 to keys[0]'s counters, as in the
    # reference.
    return (first_value(streams[0]),) + ((0,) if len(streams) > 1 else ())


# GROUP BY (d x w key/aggregate cache, paper §4.2/§8) ----------------------
def _groupby_pass1(lanes, p):
    keys, vals = lanes[0], lanes[1]
    valid = lanes[2].reshape(-1).contiguous() if len(lanes) > 2 else None
    ev, st = groupby_pass1_kernel(
        keys.reshape(-1).contiguous(),
        by_value(vals.reshape(-1)).to(torch.float32).contiguous(), valid,
        d=p["d"], w=p["w"], agg=p.get("agg", "sum"), seed=p.get("seed", 0),
        shards=keys.shape[0])
    keep = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    return keep, GroupByState(*st), tuple(e.reshape(keys.shape) for e in ev)


def _groupby_resume(st, lanes, p):
    keys, vals = lanes[0], lanes[1]
    valid = lanes[2].reshape(-1).contiguous() if len(lanes) > 2 else None
    ev, _ = groupby_pass1_kernel(
        keys.reshape(-1).contiguous(),
        by_value(vals.reshape(-1)).to(torch.float32).contiguous(), valid,
        d=p["d"], w=p["w"], agg=p.get("agg", "sum"), seed=p.get("seed", 0),
        shards=keys.shape[0], state=(st.keys, st.aggs, st.valid))
    keep = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    return keep, st, tuple(e.reshape(keys.shape) for e in ev)


def _groupby_init(lanes, p):
    return groupby_init(p["d"], p["w"], p.get("agg", "sum"), lanes[0].device)


def _groupby_merge(st, p):
    # cache-column union: the master's fold is a commutative monoid, so
    # duplicate keys across shard columns fold exactly in completion
    return GroupByState(*(kpar.cols_by_shard(x)
                          for x in (st.keys, st.aggs, st.valid)))


def _groupby_apply(merged, lanes, keep1, p):
    del merged, lanes, p
    return keep1  # all-False: every entry is absorbed into switch state


def _groupby_pads(streams, p):
    # pads carry valid=False, so the gated fold ignores key and value
    # entirely; any fill works, COUNT included
    return (first_value(streams[0]), 0, False)[:len(streams)]


_SPECS: dict[str, _AlgoSpec] = {
    "topn_det": _AlgoSpec(_topn_det_pass1, lambda s, p: (float(NEG),),
                          _topn_det_merge, _topn_det_apply, _topn_det_resume,
                          _topn_det_init),
    "topn_rand": _AlgoSpec(_topn_rand_pass1, lambda s, p: (float(NEG),),
                           _topn_rand_merge, _topn_rand_apply,
                           _topn_rand_resume, _topn_rand_init),
    "distinct": _AlgoSpec(_distinct_pass1, lambda s, p: (0,),
                          _distinct_merge, _distinct_apply, _distinct_resume,
                          _distinct_init, chunkable=True),
    # a (NEG, ..., NEG) point dominates nothing and scores below/at every
    # real point, so tail pads only (at worst) loosen the last shard
    "skyline": _AlgoSpec(_skyline_pass1, lambda s, p: (float(NEG),),
                         _skyline_merge, _skyline_apply, _skyline_resume,
                         _skyline_init, chunkable=True),
    "having": _AlgoSpec(_having_pass1, _having_pads, _having_merge,
                        _having_apply, _having_resume, _having_init,
                        sharded_needs_merge=True, max_streams=2),
    "groupby": _AlgoSpec(_groupby_pass1, _groupby_pads, _groupby_merge,
                         _groupby_apply, _groupby_resume, _groupby_init,
                         max_streams=3, pad_validity=True),
}


def _spec(algo: str, params: dict) -> _AlgoSpec:
    if algo not in ALGORITHMS:
        raise KeyError(algo)
    for k in ("state", "index_offset"):
        if k in params:
            # the reference's engine has no resume either
            raise NotImplementedError(
                f"engine_prune does not resume a scan ({k}=): fold "
                "micro-batches through core.streaming.PruneStream, or resume "
                "one lane with the core functions (topn_rand_prune, "
                "topn_det_prune, distinct_prune, skyline_prune, "
                "groupby_prune, having_prune)")
    return _SPECS[algo]


# ------------------------------------------------------- encoded streams
# Streams whose plain pad is the stream's own first element (GROUP BY and
# HAVING keys): their encoded pad is the stream's first code, which decodes
# to exactly that value, so they need no pad slot. Every other encoded
# stream pads with the ``with_pad`` slot, which decodes to the plain fill.
_FIRST_ELEMENT_PADS: dict[str, tuple[int, ...]] = {
    "groupby": (0,),
    "having": (0,),
}


def _decode_streams(streams, encs):
    """Gather each encoded stream through its dictionary."""
    return tuple(s if e is None else e.decode(s)
                 for s, e in zip(streams, encs))


def _pads_probe(streams, encs):
    """Length-1 decoded slices: enough for every pads body (they read only
    ``stream[0]`` and dtypes), without decoding the whole stream."""
    return tuple(s[:1] if e is None else e.decode(s[:1])
                 for s, e in zip(streams, encs))


def _padded_encodings(algo: str, spec: _AlgoSpec, encs, streams, params):
    """Grow each constant-fill encoding by one pad slot (see above)."""
    first_elem = _FIRST_ELEMENT_PADS.get(algo, ())
    plain = spec.pads(_pads_probe(streams, encs), params)
    return tuple(e if e is None or i in first_elem else e.with_pad(plain[i])
                 for i, e in enumerate(encs))


def _encoded_spec(algo: str, spec: _AlgoSpec, encs) -> _AlgoSpec:
    """Wrap ``spec`` so its bodies run on dictionary-encoded lanes.

    ``encs`` is a per-stream tuple of pad-slot-ready ``DictEncoding``s (from
    ``_padded_encodings``) or None. Pass 1 and apply decode their lanes with
    one ``lut[code]`` gather at entry, so their masks are those of the
    decoded streams; pads returns the codes that decode to the plain fills.
    """
    first_elem = _FIRST_ELEMENT_PADS.get(algo, ())

    def dec(lanes):
        return _decode_streams(lanes, encs)

    def pads(streams, p):
        plain = spec.pads(_pads_probe(streams, encs), p)
        return tuple(
            plain[i] if encs[i] is None
            else first_value(streams[i]) if i in first_elem
            else encs[i].pad_code
            for i in range(len(plain)))

    return dataclasses.replace(
        spec, pass1=lambda lanes, p: spec.pass1(dec(lanes), p),
        apply=lambda mg, lanes, k1, p: spec.apply(mg, dec(lanes), k1, p),
        resume=lambda st, lanes, p: spec.resume(st, dec(lanes), p),
        init=lambda lanes, p: spec.init(dec(lanes), p), pads=pads)


# ------------------------------------------------------------------ layout
def shard_stack(arr: torch.Tensor, shards: int, fill=0) -> torch.Tensor:
    """[m, ...] -> [S, ceil(m/S), ...] contiguous chunks, the last
    tail-padded with ``fill``: shard i holds entries [i*n, (i+1)*n)."""
    return _pad_to(arr, shards, fill)[0].reshape((shards, -1)
                                                 + tuple(arr.shape[1:]))


def _unshard(x: torch.Tensor, m: int) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))[:m]


def unshard_mask(keep: torch.Tensor, m: int, mesh=None) -> torch.Tensor:
    """Stacked [S, n] keep mask -> flat bool[m] (inverse of shard_stack):
    the lanes in stream order, the tail pads dropped.

    A resident pass 2 (``pass2="mesh"``) across processes leaves each
    process its own lanes; with that ``mesh`` the flat masks of every
    process are gathered over its group: the O(m) bools that are the only
    gather a resident pass 2 needs, never the entries. A torch tensor does
    not carry its sharding, so the mesh is passed."""
    if mesh is not None and mesh.world > 1:
        keep = mesh.all_gather([keep.reshape(-1)])
    return _unshard(keep, m)


def _lane(state, i: int):
    """Lane i of a stacked state: every tensor field indexed, the rest kept."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name)[i] for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def _apply_chunked(apply_fn, pads_fn, merged, lanes, keep1, params,
                   block: int) -> torch.Tensor:
    """Run an apply body over blocks of ``block`` entries of every lane.

    Exact for an apply that is elementwise over entries: each block keeps
    its lanes as the leading axis, so lane ranks are unchanged.
    """
    n = keep1.shape[1]
    nb = -(-n // block)
    flat = tuple(_unshard(s, s.shape[0] * s.shape[1]) for s in lanes)
    lanes = tuple(_pad_to(s, block, f, dim=1)[0]
                  for s, f in zip(lanes, pads_fn(flat, params)))
    keep1, _ = _pad_to(keep1, block, False, dim=1)
    out = []
    for j in range(nb):
        cut = slice(j * block, (j + 1) * block)
        out.append(apply_fn(merged, tuple(s[:, cut].contiguous()
                                          for s in lanes),
                            keep1[:, cut].contiguous(), params))
    return torch.cat(out, dim=1)[:, :n]


def merge_states(algo: str, stacked_states, **params):
    """Fold S shard-local switch states into one global state."""
    return _spec(algo, params).merge(stacked_states, params)


def apply_merged(algo: str, merged, shard_streams, keep1, **params):
    """The pass-2 filter of ``algo`` on stacked lanes: keep bool[S, n]."""
    return _spec(algo, params).apply(merged, tuple(shard_streams), keep1,
                                     params)


def _state_nbytes(state) -> int:
    """Bytes of a state's tensor fields (its static fields, such as
    ``CountMin.seed``, are not state), as the JAX package counts the leaves
    of a state pytree."""
    return sum(int(v.nbytes) for v in (getattr(state, f.name) for f in
                                       dataclasses.fields(state))
               if isinstance(v, torch.Tensor))


def _obs_mask_counts(rec, keep: torch.Tensor, m: int, *,
                     encoded: bool = False, queries: int = 1,
                     partial: bool = False) -> None:
    """Feed the per-call mask counters from the materialised keep mask
    (bool[m], stacked [S, n], or either with a leading Q axis for a batch
    of ``queries``): one sum and one host read of the count. ``partial``:
    the mask holds this process's lanes only (a resident pass 2 across
    processes), so the kept count is not read."""
    scanned = int(m) * queries
    rec.count("entries_scanned", scanned)
    if partial:
        return
    kept = int(rec.sync(keep).reshape(queries, -1)[:, :m].sum())
    rec.count("entries_kept", kept)
    if encoded and scanned:
        # pruning on codes: only the survivors are ever decoded
        rec.count("decode_skipped_ratio", 1.0 - kept / scanned)


# ------------------------------------------------------ adaptive S choice
# (algo, stream signature, scalar params, device) -> (merge cost c, per-lane
# state bytes). c is in the planner's units: the master's cost of folding
# one shipped state byte, in per-entry stream work, so that
# T(S) = m/S + c·S·state_bytes.
_CALIBRATION: dict[tuple, tuple[float, int]] = {}

_PROBE_SHARDS = 4
_PROBE_N = 256  # entries a probe lane


def _calibration_key(algo: str, streams, params: dict) -> tuple:
    """The key of ``_CALIBRATION``: dtypes by their numpy names, trailing
    shapes, the scalar params and the device."""
    return (algo,
            tuple((str(s.dtype).removeprefix("torch."), tuple(s.shape[1:]))
                  for s in streams),
            tuple(sorted((k, v) for k, v in params.items()
                         if isinstance(v, (int, float, str, bool)))),
            str(streams[0].device))


def _probe_streams(streams) -> tuple:
    """Small streams of the real dtypes and trailing shapes on the streams'
    device, made from the shapes alone with ``np.random.default_rng(0)``, as
    the JAX package makes its probes."""
    rng = np.random.default_rng(0)
    m = _PROBE_SHARDS * _PROBE_N
    out = []
    for s in streams:
        shape = (m,) + tuple(s.shape[1:])
        if s.dtype.is_floating_point:
            a = torch.from_numpy(
                (rng.random(shape) * 100 + 1).astype(np.float32)).to(s.dtype)
        elif s.dtype == torch.bool:
            a = torch.ones(shape, dtype=torch.bool)
        else:
            a = torch.from_numpy(rng.integers(1, 1000, shape)).to(s.dtype)
        out.append(a.to(s.device))
    return tuple(out)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn, device: torch.device) -> float:
    """The median of three timed calls of ``fn`` after a warm one, in µs,
    the device synchronised before each clock read."""
    fn()
    times = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e6)
    return sorted(times)[1]


def calibrate_merge_cost(algo: str, streams, params: dict
                         ) -> tuple[float, int]:
    """Measure the merge cost of ``algo`` once; cached per signature.

    Runs pass 1 over _PROBE_SHARDS lanes of _PROBE_N probe entries on the
    streams' device, times (a) the one-lane pass 1 over all the probe
    entries and (b) the merge of the lanes' states, with the port's own
    kernels, and returns (c, state_bytes): c the measured merge cost per
    shipped state byte in per-entry units (``planner.optimal_shards``'s
    constant), state_bytes one lane's state. The result is recorded in
    ``planner.MEASURED_MERGE_COSTS`` too."""
    key = _calibration_key(algo, streams, params)
    if key in _CALIBRATION:
        return _CALIBRATION[key]
    spec = _spec(algo, params)
    probes = _probe_streams(streams)
    lanes = tuple(shard_stack(p, _PROBE_SHARDS) for p in probes)
    _, stacked, _ = spec.pass1(lanes, params)
    state_bytes = _state_nbytes(stacked) // _PROBE_SHARDS
    dev = probes[0].device
    flat = tuple(p[None] for p in probes)
    us_scan = _time_us(lambda: spec.pass1(flat, params), dev)
    us_merge = _time_us(lambda: spec.merge(stacked, params), dev)
    per_entry = max(us_scan / (_PROBE_SHARDS * _PROBE_N), 1e-9)
    c = (us_merge / max(_PROBE_SHARDS * state_bytes, 1)) / per_entry
    _CALIBRATION[key] = (c, state_bytes)
    planner.MEASURED_MERGE_COSTS[algo] = c
    return c, state_bytes


def _resolve_shards(algo: str, streams, params: dict, mode: str,
                    shards, ndev: int = 1) -> int:
    """Turn shards=None / "auto" into a lane count for ``mode``; ``ndev``
    is the mesh's position count (1 outside mode="mesh"). None is 8 (capped
    at m), or one lane a position in mesh mode; "auto" is 1 for ``scan`` and
    else the planner's ``optimal_shards`` over the calibrated merge cost,
    capped at m (in mesh mode rounded up to a multiple of ndev, and down to
    the stream). An int passes through (``engine_prune`` checks it)."""
    m = streams[0].shape[0]
    if isinstance(shards, int):
        return shards
    if shards is None:
        return ndev if mode == "mesh" else min(8, m)
    if shards != "auto":
        raise ValueError(
            f"shards must be an int, None or 'auto', got {shards!r}")
    if mode == "scan":
        return 1
    c, state_bytes = calibrate_merge_cost(algo, streams, params)
    s = planner.optimal_shards(m, state_bytes, merge_byte_cost=c)
    if mode == "mesh":
        if m < ndev:
            raise ValueError(f"stream length {m} is shorter than the mesh "
                             f"axis ({ndev} devices)")
        s = -(-s // ndev) * ndev           # round up to a lane multiple
        s = min(s, m // ndev * ndev)       # ...but never past the stream
        return max(s, ndev)
    return max(1, min(s, m))


# ---------------------------------------------------------------- the mesh
def _mesh_for_shards(shards: int, axis: str, device=None) -> Mesh:
    """The largest default mesh of ``device`` whose position count divides
    S, so that S lanes spread evenly and any S runs: the lane count, not
    the device count, is what the keep mask depends on."""
    ndev = default_positions(device)
    d = max(k for k in range(1, min(ndev, shards) + 1) if shards % k == 0)
    return default_mesh(axis, d, device=device)


def _mesh_lanes(shards: int, ndev: int) -> int:
    """Lanes a position (S/D); the one place the mesh modes check that an
    explicit mesh's axis size divides the lane count."""
    if shards % ndev:
        raise ValueError(
            f"mode='mesh' needs shards divisible by the mesh axis size "
            f"({shards} lanes over {ndev} devices); use shards='auto'")
    return shards // ndev


def _position_lanes(lanes: tuple, lane0: int, n: int, device) -> tuple:
    """Lanes [lane0, lane0 + n) of each stream, on ``device``."""
    return tuple(s[lane0:lane0 + n].to(device) for s in lanes)


def _mesh_pass1(spec: _AlgoSpec, lanes: tuple, params: dict, mesh: Mesh):
    """Pass 1 on the mesh: each position runs the pass-1 kernels on its own
    S/D lanes (one launch over them); every position's keep, state and
    emissions are then gathered to the master, ``devices[0]``, in the
    stacked [S, ...] layout of the one-device pass 1 (the reference's
    ``out_specs=P(axis)``)."""
    L = _mesh_lanes(lanes[0].shape[0], mesh.shape[mesh.axis])
    parts = [spec.pass1(_position_lanes(lanes, g0, L, dev), params)
             for dev, g0 in mesh.positions(L)]
    return tuple(mesh.all_gather([p[i] for p in parts]) for i in range(3))


def _apply_at(spec: _AlgoSpec, merged, local: tuple, keep1, params: dict,
              lane0: int, apply_block: int | None) -> torch.Tensor:
    """One position's pass 2 on its lanes, which start at global lane
    ``lane0``."""
    p2 = dict(params, _lane0=lane0)
    if apply_block and spec.chunkable and apply_block < local[0].shape[1]:
        return _apply_chunked(spec.apply, spec.pads, merged, local, keep1,
                              p2, apply_block)
    return spec.apply(merged, local, keep1, p2)


def _mesh_two_pass_resident(spec: _AlgoSpec, lanes: tuple, params: dict,
                            mesh: Mesh, apply_block: int | None):
    """Both passes on the mesh: the master never touches the stream.

    Each position scans its resident S/D lanes; only the compact lane states
    are gathered over the mesh (S x one lane's state bytes to each of the D
    positions: "ship state upward, not entries"); every device folds the
    same merge (that is the broadcast) and each position applies it to its
    own lanes, whose global lane ranks start at its ``lane0``. Returns this
    process's keep [S_proc, n] and emissions on ``devices[0]`` (all S lanes
    in one process) and the merged state there."""
    L = _mesh_lanes(lanes[0].shape[0], mesh.shape[mesh.axis])
    pos = mesh.positions(L)
    local = [_position_lanes(lanes, g0, L, dev) for dev, g0 in pos]
    parts = [spec.pass1(x, params) for x in local]
    gathered = mesh.all_gather([p[1] for p in parts])
    home = mesh.devices[0]
    merged = mesh.replicate(gathered, lambda g: spec.merge(g, params))
    keep2 = [_apply_at(spec, merged[dev], x, p[0], params, g0, apply_block)
             .to(home) for (dev, g0), x, p in zip(pos, local, parts)]
    ev = None
    if parts[0][2] is not None:
        ev = tuple(torch.cat([p[2][i].to(home) for p in parts])
                   for i in range(len(parts[0][2])))
    return torch.cat(keep2), merged[home], ev


def _per_shard_state_bytes(spec: _AlgoSpec, lanes: tuple, params: dict
                           ) -> int:
    """One lane's switch-state bytes, from an empty lane state (no pass 1
    runs): what the resident gather ships a lane."""
    return _state_nbytes(spec.init(tuple(s[:1, :1] for s in lanes), params))


def reset_caches() -> None:
    """Forget the merge-cost calibration and the planner's mirror of it
    (tests reset them between cases, so no plan depends on which test
    calibrated first)."""
    _CALIBRATION.clear()
    planner.MEASURED_MERGE_COSTS.clear()


def engine_prune(algo: str, *streams, options: ExecOptions | None = None,
                 mode: str | None = None,
                 shards: int | str | None = None, mesh=None,
                 mesh_axis: str = "shards", apply_block: int | None = None,
                 pass2: str | None = None, tune: str | None = None,
                 plan_cache=None, encoding=None, decode: str | None = None,
                 obs: str | None = None, **params) -> PruneResult:
    """Run pruner ``algo`` over its stream in the requested mode.

    streams: arrays of m entries on the device to run on: f32 values for
    ``topn_det`` and ``topn_rand``, uint32 fingerprints for ``distinct``,
    points [m, D] for ``skyline``, keys plus (optionally) values for
    ``having``, and keys, values and (optionally) a bool validity column
    for ``groupby``. A ragged
    m is handled by tail-padding the final shard with neutral entries (NEG
    for TOP-N and SKYLINE, 0 for DISTINCT, ``(keys[0], 0)`` for HAVING,
    ``(keys[0], 0, False)`` for GROUP BY, which appends an all-True validity
    column when it was given none).

    shards: lane count S (``None``: 8, capped at m; ``"auto"``: 1 for
    ``scan``, else the planner's argmin of T(S) = m/S + c·S·state_bytes with
    the merge cost c measured once per algorithm and signature,
    ``calibrate_merge_cost``). apply_block: chunk size of the DISTINCT and
    SKYLINE pass-2 filters; the mask is the same with or without it.

    options: an ``ExecOptions`` bundling mode / shards / pass2 /
    apply_block / tune / plan_cache / decode / obs; the keyword arguments
    keep working, and a conflict warns (``options=`` wins).

    obs: the telemetry level (``"off"`` / ``"counters"`` / ``"trace"``,
    default ``repro_torch.obs.default_level()``, normally ``"counters"``).
    Above ``"off"`` the result's ``report`` is an ``ExecReport``: entries
    scanned and kept, the prune ratio, merge collectives and the bytes of
    the stacked pass-1 states shipped to the master, the share of an
    encoded stream never decoded; ``"trace"`` adds wall-clock spans (scan,
    pass1, gather_merge, pass2_apply) to ``repro_torch.obs.TRACER``, the
    card synchronised at each span's end. The counters read the finished
    mask, so the mask is bit-identical at every level.

    Returns a PruneResult whose keep mask is over the original m entries
    (stacked [S, n] over the padded stream when pass 2 is resident).
    state is the final scan state (``scan``), the stacked per-shard states
    (``sharded``) or the merged global state (``two_pass``, ``mesh``).
    emitted is GROUP BY's (evicted key, evicted aggregate, valid) streams:
    m long in ``scan``, S * ceil(m/S) long (the padded lanes, flattened)
    otherwise (this process's lanes when pass 2 is resident across
    processes).

    encoding / decode: ``encoding`` is a ``DictEncoding`` (stream 0) or a
    per-stream tuple of ``DictEncoding | None``; encoded streams carry uint32
    codes and every body decodes them at entry, so the keep mask is
    bit-identical to pruning the decoded streams. ``decode="eager"`` decodes
    them up front; ``"auto"`` / ``"late"`` (the default) prune on codes.

    mode="mesh" / mesh / mesh_axis / pass2: S lanes over the positions of
    a ``core.mesh.Mesh`` (default: the largest ``default_mesh`` of the
    streams' device whose position count divides S; an explicit mesh needs
    S divisible by ``mesh.shape[mesh_axis]``; ``shards=None`` is one lane a
    position). Each position runs pass 1 on its S/D lanes. ``pass2``:
    ``"master"`` (the default) gathers the lanes' masks, states and
    emissions to the master, ``mesh.devices[0]``, which merges and filters
    the whole stream; ``"mesh"`` gathers only the states, every device
    folds the same merge and each position filters its own lanes, so the
    keep comes back stacked [S, n] (this process's lanes across processes;
    flatten with ``unshard_mask(keep, m, mesh)``); ``"auto"`` takes the
    planner's placement rule (``planner.optimal_pass2``). The chunkable
    algorithms' pass 2 runs in blocks of ``DEFAULT_MESH_APPLY_BLOCK``
    unless ``apply_block`` says otherwise. The masks, states and emissions
    are those of ``two_pass`` at the same S, bit for bit.

    tune / plan_cache: ``"off"`` (the default) runs ``mode``;
    ``"cached"`` replays the plan cache's plan for these streams or runs
    the analytic plan, ``"race"`` races the candidate plans on a prefix
    when the cache has none and persists the winner
    (``planner.resolve_plan``; ``plan_cache`` is a ``PlanCache``, None the
    default file). The race runs on the raw code streams, the winning plan
    then with ``encoding=``; mode, shards and apply_block are the plan's.

    Scan resume (``state=`` / ``index_offset=``) is refused as the
    reference refuses it: ``core.streaming.PruneStream`` and the core
    functions resume.
    """
    opts = ExecOptions.resolve(options, mode=mode, shards=shards,
                               pass2=pass2, apply_block=apply_block,
                               tune=tune, plan_cache=plan_cache,
                               decode=decode, obs=obs)
    mode = opts.mode if opts.mode is not None else "scan"
    shards = opts.shards
    pass2 = opts.pass2 if opts.pass2 is not None else "master"
    apply_block = opts.apply_block
    decode = opts.decode if opts.decode is not None else "auto"
    tune = opts.tune if opts.tune is not None else "off"
    spec = _spec(algo, params)
    # 64-bit columns as jnp.asarray hands them to the reference
    streams = tuple(as_x32(s) for s in streams if s is not None)
    encs = normalize_encodings(encoding, len(streams))
    if decode == "eager":
        streams = _decode_streams(streams, encs)
        encs = (None,) * len(streams)
    encoded = any(e is not None for e in encs)
    if tune != "off":
        return _tuned(algo, streams, encs if encoded else None, params, opts)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if pass2 not in PASS2:
        raise ValueError(f"pass2 must be one of {PASS2}, got {pass2!r}")
    if pass2 != "master" and mode != "mesh":
        raise ValueError(
            f"pass2={pass2!r} only applies to mode='mesh' (got {mode!r})")
    if not 1 <= len(streams) <= spec.max_streams:
        raise ValueError(f"{algo} takes {spec.max_streams} stream(s) at most "
                         f"and one at least, got {len(streams)}")
    m = streams[0].shape[0]
    if any(s.shape[0] != m for s in streams):
        raise ValueError(f"{algo}: streams of unequal length "
                         f"{[s.shape[0] for s in streams]}")
    if mode == "mesh":
        ndev = (mesh.shape[mesh_axis] if mesh is not None
                else default_positions(streams[0].device))
    else:
        ndev = 1
    shards = _resolve_shards(algo, streams, params, mode, shards, ndev)
    rec = obsreport.recorder("engine_prune", opts.obs)
    if rec.active:
        rec.annotate(algo=algo, mode=mode, shards=shards, m=int(m),
                     encoded=encoded)
        if mode == "mesh":
            rec.annotate(pass2=pass2, num_devices=ndev)

    if mode == "scan" or (shards <= 1 and mode != "mesh"):
        # mesh keeps its output contract at S=1 too (the one-lane mesh: a
        # merged state, and a stacked mask when pass 2 is resident)
        if encoded:
            spec = _encoded_spec(algo, spec, _padded_encodings(
                algo, spec, encs, streams, params))
        with rec.span("scan", m=int(m)):
            keep, st, ev = spec.pass1(
                tuple(s.contiguous()[None] for s in streams), params)
            rec.sync(keep)
        res = PruneResult(keep=keep[0], state=_lane(st, 0),
                          emitted=None if ev is None
                          else tuple(e[0] for e in ev))
        return _finish(rec, res, m, encoded)
    if shards > m:
        raise ValueError(f"shards={shards} exceeds stream length {m}")
    if mode == "mesh" and mesh is None:
        mesh = _mesh_for_shards(shards, mesh_axis, streams[0].device)
    if m % shards and spec.pad_validity and len(streams) < 3:
        streams = streams + (torch.ones(m, dtype=torch.bool,
                                        device=streams[0].device),)
        encs = encs + (None,)
    if encoded:
        # from here on every body runs on the wrapped spec: decode at the
        # entry of pass 1 and apply, pads as codes of the plain fills
        spec = _encoded_spec(algo, spec, _padded_encodings(
            algo, spec, encs, streams, params))
    fills = (spec.pads(streams, params) if m % shards
             else (0,) * len(streams))
    lanes = tuple(shard_stack(s, shards, f) for s, f in zip(streams, fills))
    if mode == "mesh":
        if apply_block is None and spec.chunkable:
            apply_block = DEFAULT_MESH_APPLY_BLOCK
        if pass2 == "auto":
            # the resident gather ships the S lanes' states (the units of
            # plan_multi_switch's merge bytes)
            pass2 = planner.optimal_pass2(
                m, ndev, shards * _per_shard_state_bytes(spec, lanes, params))
        if pass2 == "mesh":
            return _mesh_resident_call(rec, spec, lanes, params, mesh,
                                       apply_block, m, encoded)
    with rec.span("pass1", mode=mode, shards=shards):
        if mode == "mesh":
            keep1, stacked, ev = _mesh_pass1(spec, lanes, params, mesh)
            lanes = tuple(s.to(mesh.devices[0]) for s in lanes)
        else:
            keep1, stacked, ev = spec.pass1(lanes, params)
        rec.sync(stacked)
    # emissions are switch->master traffic, not per-entry masks: keep the
    # full padded length, since a tail pad can evict a real partial
    emitted = None if ev is None else tuple(e.reshape(-1) for e in ev)
    if mode == "sharded" and not spec.sharded_needs_merge:
        return _finish(rec, PruneResult(keep=_unshard(keep1, m),
                                        state=stacked, emitted=emitted),
                       m, encoded)
    if rec.active:
        # the stacked pass-1 states are what crosses the wire to the
        # master: S lanes x one lane's state bytes
        rec.count("merge_collective_count", 1)
        rec.count("state_bytes_shipped", _state_nbytes(stacked))
    with rec.span("gather_merge", shards=shards):
        merged = rec.sync(spec.merge(stacked, params))
    with rec.span("pass2_apply", apply_block=apply_block or 0):
        if apply_block and spec.chunkable \
                and apply_block < lanes[0].shape[1]:
            keep2 = _apply_chunked(spec.apply, spec.pads, merged, lanes,
                                   keep1, params, apply_block)
        else:
            keep2 = spec.apply(merged, lanes, keep1, params)
        rec.sync(keep2)
    return _finish(rec, PruneResult(keep=_unshard(keep2, m), state=merged,
                                    emitted=emitted), m, encoded)


def _mesh_resident_call(rec, spec: _AlgoSpec, lanes: tuple, params: dict,
                        mesh: Mesh, apply_block, m: int,
                        encoded: bool) -> PruneResult:
    """``engine_prune``'s mode="mesh", pass2="mesh": both passes on the
    mesh. keep is stacked [S, n] in one process (this process's lanes
    across processes: ``unshard_mask(keep, m, mesh)`` flattens it)."""
    shards = lanes[0].shape[0]
    ndev = mesh.shape[mesh.axis]
    with rec.span("resident_fused", shards=shards, num_devices=ndev):
        keep2, merged, ev = _mesh_two_pass_resident(spec, lanes, params,
                                                    mesh, apply_block)
        rec.sync(keep2)
    emitted = None if ev is None else tuple(e.reshape(-1) for e in ev)
    res = PruneResult(keep=keep2, state=merged, emitted=emitted)
    if rec.active:
        # the resident gather lands every lane's state on every position:
        # S x one lane's bytes x D (the merged state's bytes would count
        # less: TOP-N det folds S thresholds into one scalar)
        rec.count("merge_collective_count", 1)
        rec.count("state_bytes_shipped",
                  shards * _per_shard_state_bytes(spec, lanes, params)
                  * ndev)
        _obs_mask_counts(rec, keep2, m, encoded=encoded,
                         partial=mesh.world > 1)
        res.report = rec.finish()
    return res


def _tuned(algo: str, streams, encoding, params: dict,
           opts: ExecOptions) -> PruneResult:
    """``engine_prune``'s ``tune`` branch: resolve a plan on the raw code
    streams (uniform across candidates, so the race is fair), then run it
    with the decode gather fused in."""
    if opts.tune not in planner.TUNE_MODES:
        raise ValueError(f"tune must be one of {planner.TUNE_MODES}, "
                         f"got {opts.tune!r}")
    if obsreport._compiling():
        raise ValueError(
            "tune= needs concrete streams (the race times real "
            "executions) — call outside jit, or pass tune='off'")
    resolved = planner.resolve_plan(algo, streams, params,
                                    tune_mode=opts.tune,
                                    cache=opts.plan_cache, obs=opts.obs)
    return execute_plan(algo, *streams, plan=resolved.plan,
                        encoding=encoding, obs=opts.obs, **params)


def execute_plan(algo: str, *streams, plan, encoding=None,
                 obs: str | None = None, **params) -> PruneResult:
    """Run one tuned or analytic ``planner.Plan`` through the engine.

    The execution contract behind ``tune=``: every plan in the tuner's
    universe maps onto the two-pass family at the plan's lane count, so
    the keep mask is bit-identical across all plans for the same stream,
    and it is returned flat over the original m entries on the streams'
    device, wherever pass 2 ran (a mesh plan runs on
    ``default_mesh(num_devices=plan.num_devices)`` of that device).
    """
    streams = tuple(s for s in streams if s is not None)
    if plan.mode == "mesh":
        dev = streams[0].device
        mesh = default_mesh("shards", num_devices=plan.num_devices,
                            device=dev)
        res = engine_prune(algo, *streams, mode="mesh", shards=plan.shards,
                           mesh=mesh, apply_block=plan.apply_block,
                           pass2=plan.pass2, encoding=encoding, obs=obs,
                           **params)
        if res.keep.ndim == 2:  # resident pass 2: stacked [S, n]
            res.keep = unshard_mask(res.keep, int(streams[0].shape[0]),
                                    mesh)
        res.keep = res.keep.to(dev)
        return res
    return engine_prune(algo, *streams, mode="two_pass",
                        shards=plan.shards, encoding=encoding,
                        apply_block=plan.apply_block, obs=obs, **params)


def _finish(rec, res: PruneResult, m: int, encoded: bool) -> PruneResult:
    """Attach the call's ExecReport (mask counters, then ``finish``)."""
    if rec.active:
        _obs_mask_counts(rec, res.keep, m, encoded=encoded)
        res.report = rec.finish()
    return res
