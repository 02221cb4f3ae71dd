"""DISTINCT d x w FIFO cache pruning over the whole stream (paper Ex. 2).

The sequential kernel of the JAX package (``kernels/distinct_prune.py:67``)
is the pass-1 kernel of ``parallel.py`` with one lane, whose cache carries
across all blocks.
"""
from __future__ import annotations

import torch

from .parallel import distinct_shard_states_kernel


def distinct_prune_kernel(values: torch.Tensor, *, d: int, w: int,
                          block: int = 256, seed: int = 0) -> torch.Tensor:
    """keep bool[m] for uint32[m] fingerprints (m % block == 0)."""
    return distinct_shard_states_kernel(values, d=d, w=w, shards=1,
                                        block=block, seed=seed)[0]
