"""Count-Min sketch (paper Ex. 5): one-sided overestimate, so HAVING
f(key) > c never loses a qualifying key.

The engine's family: ``multi_hash(key, width, rows, seed)``, a table of the
weights' dtype (int32 for COUNT). Build and query run on the Count-Min CUDA
kernels for CUDA tensors and on their plain versions for CPU tensors. The
Bloom filter half of the JAX module belongs to JOIN (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CountMin:
    table: torch.Tensor  # int32/f32 [rows, width] (or stacked [S, rows, width])
    seed: int = 0


def cms_build(keys: torch.Tensor, weights: torch.Tensor | None, rows: int,
              width: int, seed: int = 0) -> CountMin:
    """COUNT (weights=None: int32 unit weights) or SUM sketch."""
    from ..kernels.cms_sketch import cms_build_kernel

    table = cms_build_kernel(keys.contiguous(), None if weights is None
                             else weights.contiguous(), rows=rows,
                             width=width, seed=seed, family="engine")
    return CountMin(table=table[0], seed=seed)


def cms_query(s: CountMin, keys: torch.Tensor, threshold=None) -> torch.Tensor:
    """Per-key estimate (>= the true value); with ``threshold``, the keep
    mask ``estimate > threshold`` in one pass."""
    from ..kernels.cms_sketch import cms_query_kernel

    return cms_query_kernel(s.table.contiguous(), keys.contiguous(),
                            seed=s.seed, family="engine", threshold=threshold)
