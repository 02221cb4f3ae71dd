"""GROUP BY pruning (paper §4.2/§8, Table 2 row GROUP BY).

The switch keeps a d x w matrix of (key, aggregate) pairs. For a
commutative-monoid aggregate (SUM/COUNT/MIN/MAX) an arriving entry whose key
is cached is *folded into* the cached aggregate and pruned; on a miss the
rolling replacement evicts a (key, partial) pair, emitted to the master as a
synthetic entry (the paper's packet with new values). The master folds the
emitted partials and the final state: exactly Q(D), because the aggregate
is associative and commutative.

keep[i] = False means entry i's value was absorbed into the switch state;
the emitted stream (one entry per stream entry, masked) carries the
evictions. The scan runs on the ``groupby_pass1`` CUDA kernel for CUDA
tensors and on its plain version for CPU tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels.groupby_scan import groupby_pass1_kernel, init_state
from .hashing import by_value
from .pruning import PruneResult


@dataclasses.dataclass
class GroupByState:
    keys: torch.Tensor   # uint32[d, w] (or stacked [S, d, w], merged [d, S*w])
    aggs: torch.Tensor   # f32, same shape
    valid: torch.Tensor  # bool, same shape


def groupby_init(d: int, w: int, agg: str = "sum",
                 device=None) -> GroupByState:
    """Empty cache on ``device`` (None: the card)."""
    keys, aggs, valid = init_state(1, d, w, agg, resolve_device(device))
    return GroupByState(keys=keys[0], aggs=aggs[0], valid=valid[0])


def groupby_prune(keys: torch.Tensor, values: torch.Tensor,
                  valid: torch.Tensor | None = None, *, d: int, w: int,
                  agg: str = "sum", seed: int = 0,
                  state: GroupByState | None = None) -> PruneResult:
    """keep (all False) + the final cache + emitted (evicted_key,
    evicted_agg, evicted_valid), each over the m entries.

    valid: optional bool[m] entry-validity column. Entries with valid=False
    leave the switch state untouched (no fold, insertion or eviction): the
    hook that makes the engine's tail pads inert under every aggregate,
    COUNT included. ``state`` resumes a prior scan from its cache (the
    carried state is not changed).
    """
    carried = None if state is None else tuple(
        t.reshape((1,) + tuple(t.shape)).clone()
        for t in (state.keys, state.aggs, state.valid))
    ev, st = groupby_pass1_kernel(
        keys.contiguous(), by_value(values).to(torch.float32).contiguous(),
        None if valid is None else valid.contiguous(), d=d, w=w, agg=agg,
        seed=seed, state=carried)
    keep = torch.zeros(keys.shape[0], dtype=torch.bool, device=keys.device)
    return PruneResult(keep=keep, state=GroupByState(*(s[0] for s in st)),
                       emitted=ev)


def _fold_by_key(keys: torch.Tensor, vals: torch.Tensor, agg: str) -> dict:
    """{key: aggregate} of f64 values, in the order given: sum/count by a
    sort and a segment sum; min/max as Python's ``min``/``max`` fold them
    left to right (``_fold_in_order``); one dict built at the end."""
    if keys.numel() == 0:
        return {}
    keys, order = torch.sort(keys, stable=True)
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    if agg in ("sum", "count"):
        out = torch.segment_reduce(vals[order], "sum", lengths=counts)
    else:
        out = _fold_in_order(vals[order], counts, agg)
    return dict(zip(uniq.tolist(), out.tolist()))


def _fold_in_order(vals: torch.Tensor, counts: torch.Tensor,
                   agg: str) -> torch.Tensor:
    """Per segment, ``min`` (or ``max``) folded left to right as Python's
    ``out = min(out, v)`` does: v replaces out only when v < out. A NaN
    first stays (no compare with it holds); a later NaN never replaces; of
    equal values (0.0 and -0.0) the first stays."""
    starts = torch.cumsum(counts, 0) - counts
    seg = torch.repeat_interleave(torch.arange(counts.shape[0],
                                               device=vals.device), counts)
    first = vals[starts]
    fill = float("inf") if agg == "min" else -float("inf")
    best = torch.segment_reduce(torch.where(vals.isnan(), fill, vals), agg,
                                lengths=counts)
    # the first value of the segment that equals its best one
    pos = torch.arange(vals.shape[0], device=vals.device)
    at = torch.where(vals == best[seg], pos, vals.shape[0])
    firstbest = torch.full_like(counts, vals.shape[0]).scatter_reduce(
        0, seg, at, "amin")
    # (an all-NaN segment has none; it keeps its first value)
    won = vals[firstbest.clamp(max=vals.shape[0] - 1)]
    return torch.where(first.isnan(), first, won)


def master_complete_groupby(result: PruneResult, agg: str = "sum") -> dict:
    """Fold the evicted partials and the final switch state into exact Q(D):
    a dict {key: aggregate} of Python numbers, folded in f64 on the device,
    emissions first (in stream order), then the state.

    Integer-valued sums are exact in any order; for non-integer values the
    order of the f64 sum (a segment sum here, emission order in the JAX
    package) moves the last bits. MIN and MAX fold in the reference's order
    with its NaN rule (``_fold_in_order``).
    """
    ev_k, ev_a, ev_valid = result.emitted
    st = result.state
    keys = torch.cat([by_value(ev_k.reshape(-1))[ev_valid.reshape(-1)],
                      by_value(st.keys.reshape(-1))[st.valid.reshape(-1)]])
    vals = torch.cat([ev_a.reshape(-1)[ev_valid.reshape(-1)],
                      st.aggs.reshape(-1)[st.valid.reshape(-1)]])
    return _fold_by_key(keys, vals.to(torch.float64), agg)


def groupby_oracle(keys, values, agg: str = "sum") -> dict:
    """Q(D) folded directly over the stream, in f64."""
    keys = torch.as_tensor(keys)
    values = torch.as_tensor(values, device=keys.device)
    v = (torch.ones(keys.shape[0], dtype=torch.float64, device=keys.device)
         if agg == "count" else by_value(values).to(torch.float64))
    return _fold_by_key(by_value(keys), v, agg)
