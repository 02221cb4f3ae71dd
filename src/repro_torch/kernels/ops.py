"""Public entry points of the TOP-N and DISTINCT pruning kernels.

Each pads the stream to whole blocks (``NEG`` for TOP-N, ``0`` for
DISTINCT), runs the kernels on the device the stream lives on (the CUDA
kernels for a CUDA tensor, their plain versions for a CPU tensor) and
returns a bool keep mask over the original entries.

The two-pass ``*_prune_parallel`` entry points run S pass-1 state replicas,
a plain-tensor merge and the pass-2 apply. Their keep mask is a superset of
the true survivors, not of the sequential kernel's mask.
"""
from __future__ import annotations

import torch

from ..constants import NEG
from . import parallel
from .distinct_prune import distinct_prune_kernel
from .topn_prune import topn_prune_kernel


def _pad_to(x: torch.Tensor, block: int, fill,
            dim: int = 0) -> tuple[torch.Tensor, int]:
    """Tail-pad ``x`` along ``dim`` with ``fill`` to a multiple of ``block``;
    returns (padded, original length). uint32 pads through its int32 view,
    so ``fill`` must be below 2^31."""
    m = x.shape[dim]
    pad = (-m) % block
    if pad == 0:
        return x, m
    if x.dtype == torch.uint32:
        padded, _ = _pad_to(x.view(torch.int32), block, int(fill), dim)
        return padded.view(torch.uint32), m
    shape = list(x.shape)
    shape[dim] = pad
    tail = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=dim), m


def distinct_prune(values: torch.Tensor, *, d: int, w: int, block: int = 256,
                   seed: int = 0) -> torch.Tensor:
    """bool[m] keep mask (FIFO d x w cache, block semantics)."""
    v, m = _pad_to(values.contiguous(), block, 0)
    return distinct_prune_kernel(v, d=d, w=w, block=block, seed=seed)[:m]


def topn_prune(values: torch.Tensor, *, d: int, w: int, block: int = 256,
               seed: int = 0) -> torch.Tensor:
    """bool[m] keep mask (randomized TOP-N matrix, block semantics)."""
    v, m = _pad_to(values.to(torch.float32).contiguous(), block, float(NEG))
    return topn_prune_kernel(v, d=d, w=w, block=block, seed=seed)[:m]


def distinct_prune_parallel(values: torch.Tensor, *, d: int, w: int,
                            shards: int = 8, block: int = 256,
                            seed: int = 0) -> torch.Tensor:
    """Two-pass DISTINCT: S cache replicas + cache-union merge + apply."""
    v, m = _pad_to(values.contiguous(), shards * block, 0)
    keep1, slots, valid, _ = parallel.distinct_shard_states_kernel(
        v, d=d, w=w, shards=shards, block=block, seed=seed)
    mslots, mvalid = parallel.merge_distinct_states(slots, valid)
    keep = parallel.distinct_apply_kernel(v, keep1, mslots, mvalid, d=d,
                                          shards=shards, seed=seed)
    return keep[:m]


def topn_prune_parallel(values: torch.Tensor, *, d: int, w: int,
                        shards: int = 8, block: int = 256,
                        seed: int = 0) -> torch.Tensor:
    """Two-pass TOP-N: per-shard matrices + per-row top-w union + apply."""
    v, m = _pad_to(values.to(torch.float32).contiguous(), shards * block,
                   float(NEG))
    _, states = parallel.topn_shard_states_kernel(
        v, d=d, w=w, shards=shards, block=block, seed=seed)
    merged = parallel.merge_topn_states(states, w)
    keep = parallel.topn_apply_kernel(v, merged, d=d, shards=shards,
                                      seed=seed)
    return keep[:m]
