"""SKYLINE w-point pruning over the whole stream (paper Ex. 6).

The sequential kernel of the JAX package (``kernels/skyline_prune.py:70``) is
the pass-1 kernel of ``parallel.py`` with one lane, whose store carries
across all blocks, and the Pallas kernel's APH association (``form="kernel"``).
"""
from __future__ import annotations

import torch

from .parallel import skyline_shard_states_kernel


def skyline_prune_kernel(points: torch.Tensor, *, w: int, block: int = 256,
                         score: str = "aph") -> torch.Tensor:
    """keep bool[m] for f32[m, D] points (m % block == 0)."""
    return skyline_shard_states_kernel(points, w=w, shards=1, block=block,
                                       score=score, form="kernel")[0]
