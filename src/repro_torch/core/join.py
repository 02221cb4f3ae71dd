"""JOIN pruning (paper §4.3 Ex. 4): two-pass Bloom-filter join.

Pass 1 streams the join column of both tables, building Bloom filters F_A
and F_B. Pass 2 prunes an A entry if F_B reports no match (and vice versa).
Bloom false positives only lower the pruning rate: matched entries always
survive. Small-table-first: stream the small table unpruned, then prune
only the large one.
"""
from __future__ import annotations

import torch

from .hashing import by_value
from .pruning import PruneResult
from .sketches import bloom_build, bloom_query


def join_prune(keys_a: torch.Tensor, keys_b: torch.Tensor, *, nbits: int,
               num_hashes: int = 3,
               seed: int = 0) -> tuple[PruneResult, PruneResult]:
    """Symmetric two-pass Bloom join pruning for both tables (F_A seeded
    ``seed``, F_B ``seed + 7919``)."""
    fa = bloom_build(keys_a, nbits, num_hashes, seed=seed)
    fb = bloom_build(keys_b, nbits, num_hashes, seed=seed + 7919)
    keep_a = bloom_query(fb, keys_a)
    keep_b = bloom_query(fa, keys_b)
    return PruneResult(keep=keep_a, state=fa), PruneResult(keep=keep_b,
                                                           state=fb)


def join_prune_asymmetric(keys_small: torch.Tensor, keys_large: torch.Tensor,
                          *, nbits: int, num_hashes: int = 3,
                          seed: int = 0) -> tuple[PruneResult, PruneResult]:
    """Small-table-first: the small table streams unpruned; only the large
    one is pruned."""
    fs = bloom_build(keys_small, nbits, num_hashes, seed=seed)
    keep_large = bloom_query(fs, keys_large)
    ones = torch.ones(keys_small.shape[0], dtype=torch.bool,
                      device=keys_small.device)
    return (PruneResult(keep=ones, state=fs),
            PruneResult(keep=keep_large, state=None))


def master_complete_join(keys_a, vals_a, keep_a, keys_b, vals_b, keep_b):
    """Exact inner join of the forwarded streams, on their device.

    Returns three aligned tensors ``(key, val_a, val_b)``, one entry per
    matching pair, in the order of the JAX package's
    ``sorted(list of (key, val_a, val_b))``: lexicographic by key, then
    val_a, then val_b, ties in A order then B order. uint32 keys and values
    come back as int64 by value; other columns keep their dtype (integer
    keys as int64). Equals the join of the full data.

    A sort-merge join: B's kept keys sorted once, each kept A key finds its
    run of matches by ``searchsorted``, and ``repeat_interleave`` expands
    the runs; three stable sorts give the lexicographic order. A NaN key
    joins nothing (the reference's dict of keys matches by ``==``), so NaN
    keys leave both sides before the merge.
    """
    ka, kb = by_value(keys_a), by_value(keys_b)
    if ka.is_floating_point():
        keep_a = keep_a & ~ka.isnan()
    if kb.is_floating_point():
        keep_b = keep_b & ~kb.isnan()
    ka, kb = ka[keep_a], kb[keep_b]
    va, vb = by_value(vals_a)[keep_a], by_value(vals_b)[keep_b]
    if ka.dtype != kb.dtype:  # an integer and a float key column
        ka, kb = ka.to(torch.float64), kb.to(torch.float64)
    kb, order = torch.sort(kb, stable=True)
    vb = vb[order]
    lo = torch.searchsorted(kb, ka, side="left")
    cnt = torch.searchsorted(kb, ka, side="right") - lo
    ia = torch.repeat_interleave(torch.arange(ka.shape[0], device=ka.device),
                                 cnt)
    starts = torch.cumsum(cnt, 0) - cnt
    ib = lo[ia] + torch.arange(ia.shape[0], device=ka.device) - starts[ia]
    out = (ka[ia], va[ia], vb[ib])
    for j in (2, 1, 0):
        o = torch.sort(out[j], stable=True).indices
        out = tuple(c[o] for c in out)
    return out


def join_oracle(keys_a, vals_a, keys_b, vals_b):
    ones_a = torch.ones(keys_a.shape[0], dtype=torch.bool,
                        device=keys_a.device)
    ones_b = torch.ones(keys_b.shape[0], dtype=torch.bool,
                        device=keys_b.device)
    return master_complete_join(keys_a, vals_a, ones_a, keys_b, vals_b,
                                ones_b)
