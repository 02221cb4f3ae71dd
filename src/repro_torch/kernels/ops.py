"""Public entry points of the pruning and Count-Min kernels.

Each pruning entry point pads the stream to whole blocks (``NEG`` for TOP-N
and SKYLINE, ``0`` for DISTINCT), runs the kernels on the device the stream
lives on (the CUDA kernels for a CUDA tensor, their plain versions for a
CPU tensor) and returns a bool keep mask over the original entries.

The two-pass ``*_prune_parallel`` entry points run S pass-1 state replicas,
a plain-tensor merge and the pass-2 apply. Their keep mask is a superset of
the true survivors, not of the sequential kernel's mask.

``cms_build`` / ``cms_query`` are the Count-Min sketch of HAVING with the
Pallas kernels' hash family and an f32 table.
"""
from __future__ import annotations

import torch

from ..constants import NEG
from . import parallel
from .cms_sketch import cms_build_kernel, cms_query_kernel
from .distinct_prune import distinct_prune_kernel
from .skyline_prune import skyline_prune_kernel
from .topn_prune import topn_prune_kernel


def _pad_to(x: torch.Tensor, block: int, fill,
            dim: int = 0) -> tuple[torch.Tensor, int]:
    """Tail-pad ``x`` along ``dim`` with ``fill`` to a multiple of ``block``;
    returns (padded, original length). uint32 pads through its int32 view,
    with ``fill`` taken mod 2^32."""
    m = x.shape[dim]
    pad = (-m) % block
    if pad == 0:
        return x, m
    if x.dtype == torch.uint32:
        f = int(fill) & 0xFFFFFFFF
        padded, _ = _pad_to(x.view(torch.int32), block,
                            f - (1 << 32) if f >= (1 << 31) else f, dim)
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


def skyline_prune(points: torch.Tensor, *, w: int, block: int = 256,
                  score: str = "aph") -> torch.Tensor:
    """bool[m] keep mask for [m, D] points (w-point store, block semantics).

    Pads with (NEG, ..., NEG) rows: such a point dominates nothing, even in
    all-negative data, where a zero pad would dominate every point."""
    p, m = _pad_to(points.to(torch.float32).contiguous(), block, float(NEG))
    return skyline_prune_kernel(p, w=w, block=block, score=score)[:m]


def skyline_prune_parallel(points: torch.Tensor, *, w: int, shards: int = 8,
                           block: int = 256,
                           score: str = "aph") -> torch.Tensor:
    """Two-pass SKYLINE: per-shard stores + their union + apply."""
    p, m = _pad_to(points.to(torch.float32).contiguous(), shards * block,
                   float(NEG))
    _, pts, scs = parallel.skyline_shard_states_kernel(
        p, w=w, shards=shards, block=block, score=score, form="kernel")
    mp, ms = parallel.merge_skyline_states(pts, scs)
    return parallel.skyline_apply_kernel(p, mp, ms)[:m]


def cms_build(keys: torch.Tensor, weights: torch.Tensor, *, rows: int,
              width: int, block: int = 256, seed: int = 0) -> torch.Tensor:
    """f32[rows, width] Count-Min table of the weighted keys. Pads (key 0,
    weight 0.0) to whole blocks, as the Pallas kernel's grid needs."""
    if width >= (1 << 16):
        raise ValueError("multiply-shift range reduction needs width < 2^16")
    k, _ = _pad_to(keys.contiguous(), block, 0)
    wts, _ = _pad_to(weights.to(torch.float32).contiguous(), block, 0.0)
    return cms_build_kernel(k, wts, rows=rows, width=width, seed=seed)[0]


def cms_query(table: torch.Tensor, keys: torch.Tensor, *, block: int = 256,
              seed: int = 0) -> torch.Tensor:
    """f32[m] estimates: the minimum over rows of the hashed counters."""
    k, m = _pad_to(keys.contiguous(), block, 0)
    return cms_query_kernel(table.to(torch.float32).contiguous(), k,
                            seed=seed)[:m]
