"""Bloom filter build and query (paper Ex. 4, JOIN): CUDA kernels and their
plain versions.

``bloom_build_kernel`` replaces ``bloom_build_kernel`` of the JAX package
(``kernels/bloom_filter.py:39``) and ``bloom_query_kernel`` its
``bloom_query_kernel`` (``:71``); both also carry the engine's JOIN filters
(``core.sketches``). Two hash families, as for Count-Min: ``"kernel"`` is
the Pallas kernels' ``hash_mod(key, nbits, seed + 101 h)`` (nbits < 2^16),
``"engine"`` the engine's ``multi_hash(key, nbits, H, seed)`` (modulo, any
nbits).

The filter is a packed bitset, uint32[ceil(nbits / 32)], bit i in bit
i % 32 of word i // 32. ``unpack_bits`` gives the bool[nbits] view
(``BloomFilter.bits`` of the JAX package) and ``pack_bits`` the inverse; the
f32 0/1 view of the Pallas kernel is ``unpack_bits(...).float()``. Keys are
32-bit lanes (uint32, int32, or float32 hashed by its bits); the kernels'
family hashes an int32 key in the Pallas kernels' signed arithmetic, as
``cms_sketch`` does (a probe of -1 sets nothing and reads as unset).

Each entry point launches a CUDA kernel for a CUDA tensor and runs the
plain version for a CPU tensor. Both are exact: OR is idempotent, so the
bitset is the same in any order of inserts.

The build is bound by its bit sets, not its bytes: JOIN's filters take
3 * 2^25 and 3 * 2^20 sets of a 2 MiB bitset. As global atomics (the C
entry ``bloom_build_global``, the kernel of the first port) F_A's took
1.78 ms on an H100, against 0.04 ms to read its keys. So a filter that is
larger than 48 KB and fits a thread-block cluster is built by ``bloom_build``
(``csrc/bloom.cu``) in the cluster's shared memory: CTA r of a cluster of
K owns one slice of the words; each round a CTA bins its probes by owning
CTA, ships each bin to its owner's inbox in distributed shared memory, and
every CTA ORs its inbox into its slice with local atomics; each cluster
then ORs its copy into the filter (a global atomic a non-zero word). The
layout (K, the slice, the clusters the card holds) is ``csrc/bloom.cu``'s
alone, which ``cluster_plan`` asks. ``bloom_route`` is the dispatch rule: a
filter of 48 KB or less is staged whole in each CTA's shared memory by
``bloom_build_global`` (the ops form); a larger one goes to the cluster
build where a cluster holds it and the keys set at least
CLUSTER_MIN_PROBES probes a filter word, and else takes
``bloom_build_global``'s global atomics, as do filters too large for a
cluster of 16. A cluster launch that the card refuses raises.

The CUDA query (``bloom_query``) is persistent, 8 keys a thread a step by
16-byte loads: a filter of 48 KB or less is staged in each CTA's shared
memory, a larger one read from global memory (L2), each probe's word
loads issued for all of a thread's keys before it tests any, the next
probe's loads only for the keys still alive (staged, every probe is
taken). ``query_plan`` asks the C side for
the route and the grid once a device and shape. ``ops.bloom_query`` hands
it ``nonfinite_bits`` of its f32 bits, so that it reads them as the
Pallas query's one-hot product does. ``bloom_query_grid`` is the query it
replaced, kept for ``chip_smoke.py``'s witness.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..core.hashing import as_u32, hash_mod, multi_hash
from .cms_sketch import _family as cms_family
from .cms_sketch import _keys_u32
from .common import (I32, I64, P, U32, CudaKernel, check_cuda, grid_for,
                     library_fn, ptr, query_out, sm_count)

BLOOM_BUILD = CudaKernel("bloom_build", [P, P, P, I64, U32, I32, U32, I32,
                                         I32, I32])
BLOOM_BUILD_GLOBAL = CudaKernel("bloom_build_global",
                                [P, P, P, I64, U32, I32, U32, I32, I32])
BLOOM_QUERY = CudaKernel("bloom_query",
                         [P, P, P, I64, U32, I32, U32, I32, P, I32])


def _family(family: str, nbits: int,
            keys: torch.Tensor | None = None) -> int:
    """The C hash family (``cms_sketch._family``)."""
    if nbits < 1 or nbits >= (1 << 32):
        raise ValueError(f"nbits must be in [1, 2^32), got {nbits}")
    return cms_family(family, keys)


def num_words(nbits: int) -> int:
    return -(-nbits // 32)


STAGED_BYTES = 48 * 1024  # a filter staged whole in each CTA
# Probes a filter word (m * H / words) from which the cluster build takes
# less device time than the global atomics: below it, zeroing and flushing
# each cluster's copy of the filter costs more than the atomics it saves.
# On an H100 at JOIN's filter size (``chip_smoke.time_bloom_sweep``) the
# cluster build's device time is the higher at 1.5 probes a word and the
# lower from 3 on; PERF.md gives the readings.
CLUSTER_MIN_PROBES = 3


@lru_cache(maxsize=None)
def cluster_plan(device: torch.device, nbits: int,
                 num_hashes: int) -> tuple[int, int, int]:
    """(K, slice words, clusters the card holds at once) of the cluster
    build of a filter of nbits, as ``csrc/bloom.cu`` lays it out
    (``bloom_cluster_plan``); K = 0 where no cluster of at most 16 CTAs
    holds it. Raises where the card holds no cluster of K."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = library_fn("bloom_cluster_plan",
                         [U32, I32, ctypes.POINTER(ctypes.c_int)], I32)(
            nbits, num_hashes, out)
    if err:
        raise RuntimeError(f"bloom_cluster_plan failed: cudaError {err}")
    K, sl, n = out
    if K and n < 1:
        raise RuntimeError(f"the card holds no cluster of {K} CTAs with "
                           f"{sl * 4} bytes of filter each")
    return K, sl, n


def bloom_route(nbits: int, num_hashes: int, m: int, K: int) -> str:
    """Which kernel builds the filter of m keys into nbits on the card, K
    being ``cluster_plan``'s: "staged" (48 KB or less: ``bloom_build_global``
    with a copy in each CTA), "cluster" (``bloom_build`` in a cluster's
    shared memory, where a cluster holds the filter and the keys set at
    least CLUSTER_MIN_PROBES probes a word) or "global"
    (``bloom_build_global``'s global atomics)."""
    nw = num_words(nbits)
    if nw * 4 <= STAGED_BYTES:
        return "staged"
    if K and m * num_hashes >= CLUSTER_MIN_PROBES * nw:
        return "cluster"
    return "global"


def probe_bits(keys: torch.Tensor, nbits: int, num_hashes: int, seed: int,
               family: str) -> torch.Tensor:
    """int64 [m, H]: the bit each of the H hashes of each key probes."""
    if _family(family, nbits) == 1:
        return multi_hash(keys, nbits, num_hashes, seed)
    signed = keys.dtype == torch.int32
    return torch.stack([hash_mod(keys, nbits, (seed + 101 * h) & 0xFFFFFFFF,
                                 signed=signed)
                        for h in range(num_hashes)], -1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[nbits] -> uint32[ceil(nbits / 32)] packed words."""
    nbits = bits.shape[0]
    b = torch.zeros(num_words(nbits) * 32, dtype=torch.int64,
                    device=bits.device)
    b[:nbits] = bits.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = (b.reshape(-1, 32) << shifts).sum(1)
    w = torch.where(w >= (1 << 31), w - (1 << 32), w)
    return w.to(torch.int32).view(torch.uint32)


def unpack_bits(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """uint32[ceil(nbits / 32)] packed words -> bool[nbits]."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (as_u32(words)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:nbits].to(torch.bool)


def bloom_build_plain(keys: torch.Tensor, *, nbits: int, num_hashes: int = 3,
                      seed: int = 0, family: str = "kernel",
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain build: packed words with the H probed bits of every key whose
    mask entry is True (every key without a mask)."""
    idx = probe_bits(keys, nbits, num_hashes, seed, family)
    if mask is not None:
        idx = idx[mask]
    idx = idx.reshape(-1)
    bits = torch.zeros(nbits, dtype=torch.bool, device=keys.device)
    bits[idx[idx >= 0]] = True
    return pack_bits(bits)


def bloom_build_kernel(keys: torch.Tensor, *, nbits: int, num_hashes: int = 3,
                       seed: int = 0, family: str = "kernel",
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """uint32 packed words of the filter of ``keys`` (entries with a False
    ``mask`` left out). The kernels' family takes nbits < 2^16, as the Pallas
    kernel asserts."""
    fam = _family(family, nbits, keys)
    if fam != 1 and nbits >= (1 << 16):
        raise ValueError("the kernels' hash family needs nbits < 2^16")
    m = keys.shape[0]
    if mask is not None and (mask.shape != (m,) or mask.dtype != torch.bool):
        raise ValueError(f"mask must be bool[{m}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if not keys.is_cuda:
        return bloom_build_plain(keys, nbits=nbits, num_hashes=num_hashes,
                                 seed=seed, family=family, mask=mask)
    k = _keys_u32(keys)
    check_cuda("keys", k, torch.uint32)
    if mask is not None:
        check_cuda("mask", mask, torch.bool, keys.device)
    dev = keys.device
    nw = num_words(nbits)
    words = torch.zeros(nw, dtype=torch.int32, device=dev).view(torch.uint32)
    K = 0 if nw * 4 <= STAGED_BYTES else cluster_plan(dev, nbits,
                                                      num_hashes)[0]
    if m and bloom_route(nbits, num_hashes, m, K) == "cluster":
        BLOOM_BUILD.launch(dev, ptr(k), None if mask is None else ptr(mask),
                           ptr(words), m, nbits, num_hashes,
                           seed & 0xFFFFFFFF, fam, K,
                           cluster_plan(dev, nbits, num_hashes)[2])
    elif m:
        BLOOM_BUILD_GLOBAL.launch(dev, ptr(k),
                                  None if mask is None else ptr(mask),
                                  ptr(words), m, nbits, num_hashes,
                                  seed & 0xFFFFFFFF, fam,
                                  min(grid_for(m, dev), 4 * sm_count(dev)))
    return words


def nonfinite_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 [2] on the bits' device, with no host synchronisation: how many
    entries of an f32 bit vector are not finite (2 for two or more) and the
    first one's position (0 when there is none)."""
    bad = ~torch.isfinite(bits)
    return torch.stack([bad.sum().clamp(max=2),
                        bad.to(torch.uint8).argmax()]).to(torch.int32)


def bloom_query_plain(words: torch.Tensor, keys: torch.Tensor, *, nbits: int,
                      num_hashes: int = 3, seed: int = 0,
                      family: str = "kernel",
                      nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """Plain query: bool[m], True where all H probed bits are set.

    ``nonfinite`` (``nonfinite_bits`` of the f32 bits that ``words`` packs
    as ``bits > 0.5``) reads the bits as the Pallas query does, by one-hot
    products (``cms_sketch.onehot_reads``): with one non-finite bit, a probe
    elsewhere reads NaN, so only a key whose every probe hits that bit, set
    (+inf), is kept; with two or more, or a NaN, no key is."""
    idx = probe_bits(keys, nbits, num_hashes, seed, family)
    got = (as_u32(words)[idx.clamp(min=0) >> 5] >> (idx & 31)) & 1
    keep = (got.to(torch.bool) & (idx >= 0)).all(-1)
    if nonfinite is None or num_hashes < 1:
        return keep
    count, pos = nonfinite[0], nonfinite[1].to(torch.int64)
    at_inf = ((as_u32(words)[pos >> 5] >> (pos & 31)) & 1).to(torch.bool)
    only = (idx == pos).all(-1)
    return torch.where(count == 0, keep, (count == 1) & at_inf & only)


def bloom_query_kernel(words: torch.Tensor, keys: torch.Tensor, *, nbits: int,
                       num_hashes: int = 3, seed: int = 0,
                       family: str = "kernel",
                       nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """bool[m] membership of each key in the packed filter ``words``
    (``nonfinite``: as ``bloom_query_plain`` takes it)."""
    fam = _family(family, nbits, keys)
    if words.shape != (num_words(nbits),) or words.dtype != torch.uint32:
        raise ValueError(f"words must be uint32[{num_words(nbits)}], got "
                         f"{words.dtype} {tuple(words.shape)}")
    if not keys.is_cuda:
        return bloom_query_plain(words, keys, nbits=nbits,
                                 num_hashes=num_hashes, seed=seed,
                                 family=family, nonfinite=nonfinite)
    m = keys.shape[0]
    k = _keys_u32(keys)
    check_cuda("keys", k, torch.uint32)
    check_cuda("words", words, torch.uint32, keys.device)
    dev = keys.device
    if nonfinite is not None:
        check_cuda("nonfinite", nonfinite, torch.int32, dev)
    keep = query_out(k, m, torch.bool)
    if m:
        BLOOM_QUERY.launch(dev, ptr(words), ptr(k), ptr(keep), m, nbits,
                           num_hashes, seed & 0xFFFFFFFF, fam,
                           None if nonfinite is None or num_hashes < 1
                           else ptr(nonfinite),
                           query_plan(dev, nbits, num_hashes, fam)[1])
    return keep


@lru_cache(maxsize=None)
def query_plan(device: torch.device, nbits: int, num_hashes: int,
               fam: int) -> tuple[int, int]:
    """(route: 1 the words staged in shared memory, 0 read from global
    memory; the persistent grid's CTAs) of the CUDA query on ``device``, as
    ``csrc/bloom.cu`` plans it (``bloom_query_plan``), asked once a device
    and shape."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = library_fn("bloom_query_plan",
                         [U32, I32, I32, ctypes.POINTER(ctypes.c_int)], I32)(
            nbits, num_hashes, fam, out)
    if err:
        raise RuntimeError(f"bloom_query_plan failed: cudaError {err}")
    return int(out[0]), int(out[1])
