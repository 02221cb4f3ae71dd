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

import math
import numbers

import torch

from ..device import resolve_device
from .hashing import as_u32
from .pruning import PruneResult
from .sketches import JIT_ZERO_ROWS, CountMin, cms_query, plus_zero_rows


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
    """Sketch f per key; keep[i] = est(key_i) > threshold.

    The batch's sketch is built as the reference's jitted body builds it
    (``sketches.plus_zero_rows`` from row ``JIT_ZERO_ROWS``). ``state``: a
    carried sketch the batch's table is added to (``add_tables``: wrapping
    for integers, flushed for f32), and ``keep`` is judged against that
    running estimate, which underestimates the final one (a stream must not
    prune on it mid-stream, ``core.streaming``). The carried state is not
    changed."""
    weights = None if agg == "count" else values
    table = batch_table(keys, weights, rows, width, seed)[0]
    if state is not None:
        table = add_tables(state.table, table)
    sketch = CountMin(table=table, seed=seed)
    return PruneResult(keep=cms_query(sketch, keys, threshold), state=sketch)


def batch_table(keys: torch.Tensor, weights: torch.Tensor | None, rows: int,
                width: int, seed: int = 0, shards: int = 1) -> torch.Tensor:
    """One batch's Count-Min tables [shards, rows, width], lane s over the
    keys [s * m/S, (s+1) * m/S), as the reference's jitted HAVING body
    builds them: the scatter-add of each row into a table of +0, that add
    dropped in rows 0 and 1 (``JIT_ZERO_ROWS``)."""
    from ..kernels.cms_sketch import cms_build_kernel

    t = cms_build_kernel(keys.contiguous(), None if weights is None
                         else weights.contiguous(), rows=rows, width=width,
                         seed=seed, family="engine", shards=shards)
    return plus_zero_rows(t, JIT_ZERO_ROWS)


def add_tables(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a + b`` of two Count-Min tables as XLA adds them: an integer table
    wraps in its dtype, an f32 one flushes operands and sum (A25), an f16
    one rounds the sum to f16."""
    from ..kernels.cms_sketch import INT_TABLES, by_value_i64, wrap_to
    from ..kernels.common import ftz_add

    if a.dtype in INT_TABLES:
        return wrap_to(by_value_i64(a) + by_value_i64(b), a.dtype)
    if a.dtype == torch.float32:
        return ftz_add(a, b)
    return a + b


def master_complete_having(keys, values, keep, threshold, agg: str = "sum"):
    """Master: exact aggregate over forwarded entries; the sorted list of
    keys whose aggregate exceeds the threshold.

    Forwarded values are cast to int64 before summing, as the reference
    does (so float values are truncated toward zero, and NaN, +-inf and
    values beyond the int64 range become -2^63, as numpy casts them on
    x86). The sums are exact, as the reference's Python ints are: each
    int64 is summed as two 32-bit halves, and the compare with the
    threshold is exact (``_exceeds``).
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
             else _to_int64(values))[keep]
    uniq, inv = torch.unique(k, return_inverse=True)
    sums = [torch.zeros(uniq.shape[0], dtype=torch.int64,
                        device=keys.device).index_add_(0, inv, half)
            for half in (v >> 32, v & 0xFFFFFFFF)]
    return uniq[_exceeds(*sums, threshold)].tolist()


def _to_int64(values: torch.Tensor) -> torch.Tensor:
    """numpy's ``astype(np.int64)`` on x86: floats truncate toward zero;
    NaN, +-inf and anything outside [-2^63, 2^63) become -2^63."""
    if not values.is_floating_point():
        return values.to(torch.int64)
    v = values.to(torch.float64)
    ok = (v >= -(2.0 ** 63)) & (v < 2.0 ** 63)
    return torch.where(ok, v, 0.0).to(torch.int64).masked_fill(
        ~ok, -(1 << 63))


def _exceeds(hi: torch.Tensor, lo: torch.Tensor, threshold) -> torch.Tensor:
    """hi * 2^32 + lo > threshold, exactly, for summed halves hi (signed)
    and lo (each term in [0, 2^32)), as Python compares an int with an int
    or a float."""
    if isinstance(threshold, numbers.Integral):
        threshold = int(threshold)
    else:
        t = float(threshold)
        if math.isnan(t):
            return torch.zeros(hi.shape, dtype=torch.bool, device=hi.device)
        if math.isinf(t):
            return torch.full(hi.shape, t < 0, dtype=torch.bool,
                              device=hi.device)
        threshold = math.floor(t)  # an int s > t iff s > floor(t)
    hi = hi + (lo >> 32)
    lo = lo & 0xFFFFFFFF
    limit = (1 << 63) - 1
    t_hi = max(-limit, min(limit, threshold >> 32))
    t_lo = threshold & 0xFFFFFFFF if -limit < threshold >> 32 < limit else 0
    return (hi > t_hi) | ((hi == t_hi) & (lo > t_lo))


def having_oracle(keys, values, threshold, agg: str = "sum"):
    keys = torch.as_tensor(keys)
    ones = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
    return master_complete_having(keys, values, ones, threshold, agg)
