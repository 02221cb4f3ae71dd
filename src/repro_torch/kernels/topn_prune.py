"""Randomized TOP-N matrix pruning over the whole stream (paper Ex. 7, Fig. 2).

The sequential kernel of the JAX package (``kernels/topn_prune.py:49``) is the
pass-1 kernel of ``parallel.py`` with one lane: the lane hashes the global
stream index, and its f32[d, w] matrix carries across all blocks.
"""
from __future__ import annotations

import torch

from .parallel import topn_shard_states_kernel


def topn_prune_kernel(values: torch.Tensor, *, d: int, w: int,
                      block: int = 256, seed: int = 0) -> torch.Tensor:
    """keep bool[m] for f32[m] values (m % block == 0)."""
    keep, _ = topn_shard_states_kernel(values, d=d, w=w, shards=1,
                                       block=block, seed=seed)
    return keep
