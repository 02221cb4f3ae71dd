"""HAVING pruning (paper §4.3 Ex. 5): Count-Min + threshold.

HAVING f(key) > c for f in {COUNT, SUM}: the switch sketches f per key; by
the one-sided error (est >= true), pruning keys whose estimate is <= c never
loses a qualifying key. The master gets a superset of qualifying keys and
removes the false ones with an exact aggregate.

The table takes the dtype of the weights, as in the JAX package: an int32
SUM wraps mod 2^32 past 2^31 - 1, and a key whose estimate wraps negative is
then pruned (ROADMAP Queue 3); the port reproduces that bit for bit.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .hashing import as_u32
from .pruning import PruneResult
from .sketches import CountMin, cms_build, cms_query


def having_init(rows: int = 3, width: int = 1024, seed: int = 0,
                dtype=torch.int32, device=None) -> CountMin:
    """Empty sketch on ``device`` (None: the card); ``dtype`` must match
    the fold's weights (int32 for COUNT, the values' dtype for SUM)."""
    return CountMin(table=torch.zeros((rows, width), dtype=dtype,
                                      device=resolve_device(device)),
                    seed=seed)


def having_prune(keys: torch.Tensor, values: torch.Tensor | None, threshold,
                 *, rows: int = 3, width: int = 1024, agg: str = "sum",
                 seed: int = 0, state: CountMin | None = None) -> PruneResult:
    """Sketch f per key; keep[i] = est(key_i) > threshold."""
    if state is not None:
        raise NotImplementedError(
            "resuming a sketch (state=) is not ported yet; see ROADMAP "
            "Queue 1 item 9 (streaming)")
    weights = None if agg == "count" else values
    sketch = cms_build(keys, weights, rows, width, seed=seed)
    return PruneResult(keep=cms_query(sketch, keys, threshold), state=sketch)


def master_complete_having(keys, values, keep, threshold, agg: str = "sum"):
    """Master: exact aggregate over forwarded entries; the sorted list of
    keys whose aggregate exceeds the threshold.

    Forwarded values are cast to int64 before summing, as the reference
    does (so float values are truncated toward zero).
    """
    keys = torch.as_tensor(keys)
    keep = torch.as_tensor(keep, device=keys.device)
    k = (as_u32(keys) if keys.dtype == torch.uint32
         else keys.to(torch.float64) if keys.is_floating_point()
         else keys.to(torch.int64))[keep]
    if agg == "count":
        v = torch.ones(k.shape[0], dtype=torch.int64, device=k.device)
    else:
        values = torch.as_tensor(values, device=keys.device)
        v = (as_u32(values) if values.dtype == torch.uint32
             else values.to(torch.int64))[keep]
    uniq, inv = torch.unique(k, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64,
                       device=keys.device).index_add_(0, inv, v)
    over = (sums > threshold if isinstance(threshold, int)
            else sums.to(torch.float64) > threshold)
    return uniq[over].tolist()


def having_oracle(keys, values, threshold, agg: str = "sum"):
    keys = torch.as_tensor(keys)
    ones = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    return master_complete_having(keys, values, ones, threshold, agg)
