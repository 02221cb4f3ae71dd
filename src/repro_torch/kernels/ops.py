"""Public entry points of the pruning and Count-Min kernels.

Each pruning entry point pads the stream to whole blocks (``NEG`` for TOP-N
and SKYLINE, ``0`` for DISTINCT), runs the kernels on the device the stream
lives on (the CUDA kernels for a CUDA tensor, their plain versions for a
CPU tensor) and returns a bool keep mask over the original entries.

The two-pass ``*_prune_parallel`` entry points run S pass-1 state replicas,
a plain-tensor merge and the pass-2 apply. Their keep mask is a superset of
the true survivors, not of the sequential kernel's mask.

``cms_build`` / ``cms_query`` are the Count-Min sketch of HAVING with the
Pallas kernels' hash family and an f32 table; ``bloom_build`` /
``bloom_query`` the Bloom filter of JOIN with the same family, on the f32
0/1 view of the filter (packed into uint32 words for the kernels).

``rle_topn_prune`` / ``rle_distinct_prune`` prune an RLE column at run
granularity, R runs instead of m entries, and ``rle_expand_mask`` turns
their per-run answers into the flat mask, bit-identical to the flat
``topn_det`` and DISTINCT scans of the expanded column.
"""
from __future__ import annotations

import torch

from ..constants import NEG, POS
from ..core.encoding import cast_fill
from ..core.hashing import as_u32
from . import parallel
from .bloom_filter import (bloom_build_kernel, bloom_query_kernel,
                           nonfinite_bits, pack_bits, unpack_bits)
from .cms_sketch import cms_build_kernel, cms_query_kernel, wrap_i32
from .distinct_prune import distinct_prune_kernel
from .ref import distinct_keys
from .rle_scan import rle_topn_det_kernel
from .skyline_prune import skyline_prune_kernel
from .topn_prune import topn_prune_kernel


def _pad_to(x: torch.Tensor, block: int, fill,
            dim: int = 0) -> tuple[torch.Tensor, int]:
    """Tail-pad ``x`` along ``dim`` with ``fill`` to a multiple of ``block``;
    returns (padded, original length). uint32 pads through its int32 view,
    with ``fill`` taken mod 2^32; a float fill is converted as numpy
    converts it (``cast_fill``: NEG is -2^31 in int32 and -inf in float16,
    as ``jnp.full`` gives it)."""
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
    if isinstance(fill, float):
        fill = cast_fill(fill, x.dtype).item()
    tail = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=dim), m


def first_value(x: torch.Tensor):
    """``x[0]`` as a Python number that ``_pad_to`` fills back bit for bit
    (a uint32 by its value)."""
    return int(as_u32(x[:1])[0]) if x.dtype == torch.uint32 else x[0].item()


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
    # pass 1's keep is dropped, and its matrices are the same in both
    # families: the engine's skips the kernels' keep fix-up (A27)
    _, states = parallel.topn_shard_states_kernel(
        v, d=d, w=w, shards=shards, block=block, seed=seed, family="engine")
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
    return cms_build_kernel(k, wts, rows=rows, width=width, seed=seed,
                            block=block)[0]


def cms_query(table: torch.Tensor, keys: torch.Tensor, *, block: int = 256,
              seed: int = 0) -> torch.Tensor:
    """f32[m] estimates: the minimum over rows of the hashed counters."""
    k, m = _pad_to(keys.contiguous(), block, 0)
    return cms_query_kernel(table.to(torch.float32).contiguous(), k,
                            seed=seed)[:m]


def bloom_build(keys: torch.Tensor, *, nbits: int, num_hashes: int = 3,
                block: int = 256, seed: int = 0) -> torch.Tensor:
    """f32[nbits] 0/1 Bloom bits of ``keys`` (nbits < 2^16). Pads to whole
    blocks by repeating ``keys[0]``: a key 0 pad would set bits of a key
    that is not in the set, a repeated key sets none that are new."""
    fill = first_value(keys) if keys.shape[0] % block else 0
    k, _ = _pad_to(keys.contiguous(), block, fill)
    words = bloom_build_kernel(k, nbits=nbits, num_hashes=num_hashes,
                               seed=seed, family="kernel")
    return unpack_bits(words, nbits).to(torch.float32)


def bloom_query(bits: torch.Tensor, keys: torch.Tensor, *,
                num_hashes: int = 3, block: int = 256,
                seed: int = 0) -> torch.Tensor:
    """bool[m]: True where all H probed bits of ``bits`` (f32 0/1) are set,
    read as the Pallas query reads them (a non-finite bit makes the other
    bits read NaN: ``bloom_filter.bloom_query_plain``). Pads with key 0 to
    whole blocks and cuts the answer back to m."""
    k, m = _pad_to(keys.contiguous(), block, 0)
    words = pack_bits(bits > 0.5)
    return bloom_query_kernel(words, k, nbits=bits.shape[0],
                              num_hashes=num_hashes, seed=seed,
                              family="kernel",
                              nonfinite=nonfinite_bits(bits))[:m]


def rle_topn_prune(run_values: torch.Tensor, run_lengths: torch.Tensor, *,
                   N: int, w: int = 4,
                   block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Run-level deterministic TOP-N over an RLE column, no expansion.

    Returns per-run ``(head, tstar)`` int32[R]: within a run of length L the
    flat keep mask is ``(pos < head) | (pos + 1 >= tstar)``
    (``rle_expand_mask``), bit-identical to ``core.topn_det_prune`` on the
    expanded column. Pads the runs with (POS, 0) to whole blocks.
    """
    rv, R = _pad_to(run_values.to(torch.float32).contiguous(), block,
                    float(POS))
    rl, _ = _pad_to(run_lengths.to(torch.int32).contiguous(), block, 0)
    head, tstar = rle_topn_det_kernel(rv, rl, N=N, w=w, block=block)
    return head[:R], tstar[:R]


def rle_distinct_prune(run_values: torch.Tensor, *, d: int, w: int,
                       policy: str = "lru", seed: int = 0) -> torch.Tensor:
    """Run-level DISTINCT over run values converted to uint32 as the JAX
    package converts them (``jnp.asarray(run_values, jnp.uint32)``: a float
    by value, toward zero, saturating, NaN and negatives to 0; an integer
    by its 32-bit lanes): bool[R] keep mask over the run heads.

    Every entry of a run after its first hits the cache and leaves it as it
    was (FIFO skips the insert; LRU moves the front slot to the front), so
    the flat scan's state depends on the run heads only, and scanning the
    run values is exact: the flat mask is the head scatter
    ``rle_expand_mask(keep, None, run_lengths, m)``.
    """
    from ..core.distinct import distinct_prune as seq_distinct

    vals = run_values.contiguous()
    if vals.is_floating_point():
        vals = wrap_i32(distinct_keys(vals.to(torch.float32))[0]).view(
            torch.uint32)
    return seq_distinct(vals, d=d, w=w, policy=policy, seed=seed).keep


def rle_expand_mask(head: torch.Tensor, tstar: torch.Tensor | None,
                    run_lengths: torch.Tensor, total: int) -> torch.Tensor:
    """Flat bool[total] mask from per-run prefix-and-suffix descriptors.

    ``head`` is the per-run keep-prefix length (a bool run mask works: True
    is 1); ``tstar=None`` drops the suffix term (DISTINCT's head scatter).
    ``total`` must equal ``sum(run_lengths)``.
    """
    rl = run_lengths.to(torch.int64)
    starts = torch.cumsum(rl, 0) - rl
    rid = torch.repeat_interleave(torch.arange(rl.shape[0], device=rl.device),
                                  rl, output_size=total)
    pos = torch.arange(total, device=rl.device) - starts[rid]
    keep = pos < head.to(torch.int64)[rid]
    if tstar is not None:
        keep |= (pos + 1) >= tstar.to(torch.int64)[rid]
    return keep
