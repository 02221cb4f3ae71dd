"""The pruning abstraction (paper §3).

A pruner for query Q maps data D to a subset with Q(subset) = Q(D). A
pruner returns a keep mask over the stream plus its final state, and
``compact`` moves the surviving entries to the front for the master.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class PruneResult:
    """Outcome of streaming D through a pruner.

    keep:    bool[m], True for entries forwarded to the master.
    state:   the final switch state (per shard, merged, or of the scan).
    emitted: synthetic entries for the master (GROUP BY's evicted partials:
             key, aggregate and valid streams).
    """

    keep: torch.Tensor
    state: Any = None
    emitted: Any = None

    # telemetry (repro_torch.obs.ExecReport), attached by the engine's entry
    # points; a class attribute, not a field, as in the JAX package
    report = None

    @property
    def pruned_fraction(self) -> torch.Tensor:
        return 1.0 - self.keep.to(torch.float32).mean()


def compact(values: torch.Tensor, keep: torch.Tensor, fill=0):
    """Gather surviving rows to the front; returns (moved, count).

    A kept row goes to its kept-rank and a dropped row to count plus its
    dropped-rank: one O(m) scatter. Rows past ``count`` hold ``fill``.
    """
    m = keep.shape[0]
    ki = keep.to(torch.int64)
    count = ki.sum()
    ranks = torch.cumsum(ki, 0)
    idx = torch.arange(m, device=keep.device)
    dest = torch.where(keep, ranks - 1, count + idx - ranks)
    moved = torch.zeros_like(values)
    moved[dest] = values
    mask = idx < count
    if moved.ndim > 1:
        mask = mask[:, None]
    return torch.where(mask, moved, torch.full_like(moved, fill)), count


def compact_argsort(values: torch.Tensor, keep: torch.Tensor, fill=0):
    """``compact`` by a stable sort that puts the kept rows first; returns
    (moved, count). The former sort-based compact, kept as a baseline."""
    m = keep.shape[0]
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    moved = values[order]
    count = keep.to(torch.int64).sum()
    mask = torch.arange(m, device=keep.device) < count
    if moved.ndim > 1:
        mask = mask[:, None]
    return torch.where(mask, moved, torch.full_like(moved, fill)), count


def prune_rate_vs_opt(keep: torch.Tensor, opt_keep: torch.Tensor) -> dict:
    """Compare a pruner against OPT (the minimal correct survivor set)."""
    keep = keep.to(torch.float32)
    opt = opt_keep.to(torch.float32)
    return {
        "pruned": float(1 - keep.mean()),
        "opt_pruned": float(1 - opt.mean()),
        "excess_forwarded": float((keep - opt).clip(min=0).sum()),
    }
