"""DISTINCT pruning (paper §4.2 Ex. 2, Theorem 1) with an LRU or FIFO d x w
cache.

Each row of the d x w matrix caches the last w fingerprints hashed to it; a
repeat found in its row is pruned. LRU (the default) moves a hit to the
front of its row and inserts a miss at the front, dropping the last slot;
FIFO leaves a hit in place and inserts a miss at the row's rotating head.
There are no false positives, so the master receives a superset of the
distinct values. The scan runs on the pass-1 kernel with one lane and
blocks of one entry (the per-entry semantics of the JAX package's scan).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .hashing import as_u32
from .pruning import PruneResult


@dataclasses.dataclass
class DistinctState:
    slots: torch.Tensor  # uint32[d, w] cached (finger)prints
    valid: torch.Tensor  # bool[d, w]
    head: torch.Tensor   # int32[d] FIFO insert pointer (0 under LRU)


def init_state(d: int, w: int, device) -> DistinctState:
    return DistinctState(
        slots=torch.zeros((d, w), dtype=torch.uint32, device=device),
        valid=torch.zeros((d, w), dtype=torch.bool, device=device),
        head=torch.zeros((d,), dtype=torch.int32, device=device))


def distinct_prune(values: torch.Tensor, *, d: int, w: int,
                   policy: str = "lru", seed: int = 0,
                   state: DistinctState | None = None) -> PruneResult:
    """Stream uint32[m] fingerprints through the d x w cache.

    keep[i] is True iff value i was not found in its row's cache.
    ``policy`` is "lru" (the default, as in the JAX package) or "fifo".
    Other integer streams are taken by their 32-bit lanes; a float stream
    follows the JAX package's f32 compare (``kernels.ref.distinct_keys``).
    ``state`` resumes a prior scan (FIFO's head and LRU's order carried);
    the carried state is not changed.
    """
    from ..kernels.parallel import distinct_form, distinct_shard_states_kernel

    carried = None if state is None else tuple(
        t.reshape((1,) + tuple(t.shape)).clone()
        for t in (state.slots, state.valid, state.head))
    keep, slots, valid, head = distinct_shard_states_kernel(
        distinct_form(values), d=d, w=w, shards=1, block=1, seed=seed,
        policy=policy, state=carried)
    return PruneResult(keep=keep, state=DistinctState(slots[0], valid[0],
                                                      head[0]))


def master_complete_distinct(values: torch.Tensor,
                             keep: torch.Tensor) -> torch.Tensor:
    """Master-side completion: bool mask over the stream selecting the first
    forwarded occurrence of each distinct forwarded value."""
    m = values.shape[0]
    # floats group by value, as the JAX package's sort does (-0.0 is 0.0,
    # and NaN equals nothing)
    v = values if values.is_floating_point() else as_u32(values)
    sv, order = torch.sort(v, stable=True)
    sk = keep[order]
    ski = sk.to(torch.int64)
    new_seg = torch.ones(m, dtype=torch.bool, device=v.device)
    new_seg[1:] = sv[1:] != sv[:-1]
    csum = torch.cumsum(ski, 0)
    pos = torch.arange(m, device=v.device)
    seg_start = torch.cummax(torch.where(new_seg, pos, 0), 0).values
    base = (csum - ski)[seg_start]          # kept count before the run
    first_kept = sk & (csum - base == 1)
    out = torch.zeros(m, dtype=torch.bool, device=v.device)
    out[order] = first_kept
    return out


def opt_keep_distinct(values) -> torch.Tensor:
    """OPT: forward only true first occurrences (host-side oracle; returns a
    CPU bool tensor)."""
    v = as_u32(torch.as_tensor(values)).cpu().numpy()
    _, first = np.unique(v, return_index=True)
    out = np.zeros(v.shape[0], bool)
    out[first] = True
    return torch.from_numpy(out)


def thm1_bound(D: int, d: int, w: int) -> float:
    """Expected pruned fraction of duplicate entries (Theorem 1)."""
    return 0.99 * min(w * d / (D * math.e), 1.0)
