"""Shared sketch substrate: Bloom filter and Count-Min (paper Ex. 4/5).

Bloom: no false negatives, so JOIN never prunes a matching key.
Count-Min: one-sided overestimate, so HAVING f(key) > c never loses a
qualifying key.

Both take the engine's hash family, ``multi_hash(key, size, k, seed)``. The
Bloom filter is a packed uint32 bitset (``bits`` gives the bool view of the
JAX package's ``BloomFilter.bits``); the Count-Min table takes the weights'
dtype (int32 for COUNT). Build and query run on the CUDA kernels for CUDA
tensors and on their plain versions for CPU tensors.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BloomFilter:
    words: torch.Tensor  # uint32[ceil(nbits / 32)], bit i in word i // 32
    nbits: int
    num_hashes: int = 3
    seed: int = 0

    @property
    def bits(self) -> torch.Tensor:
        """bool[nbits]: the unpacked filter."""
        from ..kernels.bloom_filter import unpack_bits

        return unpack_bits(self.words, self.nbits)


def bloom_build(keys: torch.Tensor, nbits: int, num_hashes: int = 3,
                seed: int = 0,
                mask: torch.Tensor | None = None) -> BloomFilter:
    """The filter of ``keys``; entries whose ``mask`` is False are left out."""
    from ..kernels.bloom_filter import bloom_build_kernel

    if mask is not None:
        mask = mask.contiguous()
    words = bloom_build_kernel(keys.contiguous(), nbits=nbits,
                               num_hashes=num_hashes, seed=seed,
                               family="engine", mask=mask)
    return BloomFilter(words=words, nbits=nbits, num_hashes=num_hashes,
                       seed=seed)


def bloom_query(f: BloomFilter, keys: torch.Tensor) -> torch.Tensor:
    """bool[m]: True where the filter may hold the key (never a false
    negative)."""
    from ..kernels.bloom_filter import bloom_query_kernel

    return bloom_query_kernel(f.words, keys.contiguous(), nbits=f.nbits,
                              num_hashes=f.num_hashes, seed=f.seed,
                              family="engine")


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
                             width=width, seed=seed, family="engine")[0]
    return CountMin(table=plus_zero_rows(table, 0), seed=seed)


# the rows of a jitted build from which XLA keeps the add of each row's
# scatter into the table of +0 (ROADMAP Queue 3 A29)
JIT_ZERO_ROWS = 2


def plus_zero_rows(table: torch.Tensor, first: int) -> torch.Tensor:
    """A float table [..., rows, width] as the reference leaves it after it
    adds each row's scatter into a table of +0: rows ``first`` and up read
    a sum flushed to -0 as +0. ``core.sketches.cms_build`` runs eagerly and
    adds every row (first = 0); inside a jitted body (``having_prune``, the
    engine's pass 1) XLA drops that add for rows 0 and 1 and keeps it from
    row 2 on (``JIT_ZERO_ROWS``), on every shape tried."""
    if not table.is_floating_point() or first >= table.shape[-2]:
        return table
    table = table.clone()
    table[..., first:, :] += 0.0
    return table


def cms_query(s: CountMin, keys: torch.Tensor, threshold=None) -> torch.Tensor:
    """Per-key estimate (>= the true value); with ``threshold``, the keep
    mask ``estimate > threshold`` in one pass."""
    from ..kernels.cms_sketch import cms_query_kernel

    return cms_query_kernel(s.table.contiguous(), keys.contiguous(),
                            seed=s.seed, family="engine", threshold=threshold)
