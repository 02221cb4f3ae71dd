"""Count-Min sketch build and query (paper Ex. 5, HAVING): CUDA kernels and
their plain versions.

``cms_build_kernel`` replaces ``cms_build_kernel`` of the JAX package
(``kernels/cms_sketch.py:39``) and ``cms_query_kernel`` its
``cms_query_kernel`` (``:72``); both also carry the engine's HAVING sketch
(``core.sketches``). Two hash families: ``"kernel"`` is the Pallas kernels'
``hash_mod(key, width, seed + 101 r)``, ``"engine"`` the engine's
``multi_hash(key, width, rows, seed)``.

The table takes the weights' dtype: int32 (unit weights when ``weights`` is
None, as COUNT has; integer SUM), which wraps mod 2^32 as the reference's
int32 table does, or float32. Keys are 32-bit lanes (uint32, int32, or
float32 hashed by its bits).

Each entry point launches the CUDA kernel for a CUDA tensor and runs the
plain version for a CPU tensor. Integer tables are exact in any order; f32
tables built by the kernel's atomics equal the plain sequential sums only
for integer-valued weights whose sums stay below 2^24.
"""
from __future__ import annotations

import math

import torch

from ..core.hashing import hash_mod, multi_hash
from .common import (F32, I32, I64, P, U32, CudaKernel, check_cuda,
                     grid_for, ptr)

CMS_BUILD = CudaKernel("cms_build",
                       [P, P, P, I32, I32, I32, I32, U32, I32, I32, I32])
CMS_QUERY = CudaKernel(
    "cms_query", [P, P, P, P, I64, I32, I32, U32, I32, I32, I64, F32, I32])
FAMILIES = ("kernel", "engine")
DTYPES = (torch.int32, torch.float32)
_I64_MAX = (1 << 63) - 1


def _family(family: str) -> int:
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")
    return FAMILIES.index(family)


def _keys_u32(keys: torch.Tensor) -> torch.Tensor:
    """The keys' 32-bit lanes as a uint32 view (no copy)."""
    if keys.dtype == torch.uint32:
        return keys
    if keys.dtype in (torch.int32, torch.float32):
        return keys.view(torch.uint32)
    raise TypeError(f"keys must be a 32-bit dtype, got {keys.dtype}")


def row_hashes(keys: torch.Tensor, rows: int, width: int, seed: int,
               family: str) -> torch.Tensor:
    """int64 [m, rows]: the counter column of each key in each row."""
    if _family(family) == 1:
        return multi_hash(keys, width, rows, seed)
    return torch.stack([hash_mod(keys, width, (seed + 101 * r) & 0xFFFFFFFF)
                        for r in range(rows)], -1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 mod 2^32 (two's complement)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def cms_build_plain(keys: torch.Tensor, weights: torch.Tensor | None, *,
                    rows: int, width: int, seed: int = 0,
                    family: str = "kernel", shards: int = 1) -> torch.Tensor:
    """Plain build: [shards, rows, width] tables, lane s over keys
    [s * m/S, (s+1) * m/S). One index_add over all lanes and rows."""
    m = keys.shape[0]
    dev = keys.device
    dtype = torch.int32 if weights is None else weights.dtype
    lane = torch.arange(shards, device=dev).repeat_interleave(m // shards)
    cell = ((lane[:, None] * rows + torch.arange(rows, device=dev)) * width
            + row_hashes(keys, rows, width, seed, family)).reshape(-1)
    size = shards * rows * width
    if dtype == torch.int32:
        w = (torch.ones(m, dtype=torch.int64, device=dev) if weights is None
             else weights.to(torch.int64))
        acc = torch.zeros(size, dtype=torch.int64, device=dev)
        acc.index_add_(0, cell, w.repeat_interleave(rows))
        table = wrap_i32(acc)
    else:
        table = torch.zeros(size, dtype=torch.float32, device=dev)
        table.index_add_(0, cell, weights.repeat_interleave(rows))
    return table.reshape(shards, rows, width)


def _ctas_per_lane(shard_len: int, shards: int, dev: torch.device) -> int:
    """Enough CTAs to fill the card (four per SM), at least 256 entries each."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-shard_len // 256), -(-4 * sms // shards)))


def cms_build_kernel(keys: torch.Tensor, weights: torch.Tensor | None, *,
                     rows: int, width: int, seed: int = 0,
                     family: str = "kernel", shards: int = 1) -> torch.Tensor:
    """Count-Min tables [shards, rows, width] of the weights' dtype, lane s
    over the contiguous keys [s * m/S, (s+1) * m/S)."""
    m = keys.shape[0]
    fam = _family(family)
    if rows < 1 or width < 1:
        raise ValueError(f"a sketch needs rows, width >= 1, got {rows}, "
                         f"{width}")
    if shards < 1 or m % shards:
        raise ValueError(f"{m} keys are not a multiple of shards={shards}")
    if weights is not None and (weights.shape != (m,)
                                or weights.dtype not in DTYPES):
        raise ValueError(f"weights must be int32 or float32 [{m}], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if not keys.is_cuda:
        return cms_build_plain(keys, weights, rows=rows, width=width,
                               seed=seed, family=family, shards=shards)
    k = _keys_u32(keys)
    check_cuda("keys", k, torch.uint32)
    if weights is not None:
        check_cuda("weights", weights, weights.dtype, keys.device)
    if shards > 65535:
        raise ValueError(f"the CUDA build takes at most 65535 lanes, got "
                         f"{shards}")
    dtype = torch.int32 if weights is None else weights.dtype
    table = torch.zeros((shards, rows, width), dtype=dtype,
                        device=keys.device)
    if m:
        CMS_BUILD.launch(keys.device, ptr(k),
                         None if weights is None else ptr(weights),
                         ptr(table), shards, m // shards, rows, width,
                         seed & 0xFFFFFFFF, fam, int(dtype == torch.int32),
                         _ctas_per_lane(m // shards, shards, keys.device))
    return table


def _int_threshold(threshold) -> int:
    """An int table compares est > floor(threshold) in integers."""
    t = math.floor(threshold)
    return max(-_I64_MAX - 1, min(_I64_MAX, t))


def cms_query_plain(table: torch.Tensor, keys: torch.Tensor, *,
                    seed: int = 0, family: str = "kernel",
                    threshold=None) -> torch.Tensor:
    """Plain query: est[m] = min over rows of table[r, hash_r(key)], or
    keep bool[m] = est > threshold when a threshold is given."""
    rows, width = table.shape
    idx = row_hashes(keys, rows, width, seed, family)
    est = table[torch.arange(rows, device=table.device), idx].amin(-1)
    if threshold is None:
        return est
    if table.dtype == torch.int32:
        return est.to(torch.int64) > _int_threshold(threshold)
    return est > torch.tensor(threshold, dtype=torch.float32)


def cms_query_kernel(table: torch.Tensor, keys: torch.Tensor, *,
                     seed: int = 0, family: str = "kernel",
                     threshold=None) -> torch.Tensor:
    """est[m] (the table's dtype) = min over rows of the hashed counters;
    with ``threshold``, the fused keep bool[m] = est > threshold instead."""
    fam = _family(family)
    if table.ndim != 2 or table.dtype not in DTYPES:
        raise ValueError(f"table must be int32 or float32 [rows, width], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if not keys.is_cuda:
        return cms_query_plain(table, keys, seed=seed, family=family,
                               threshold=threshold)
    rows, width = table.shape
    m = keys.shape[0]
    k = _keys_u32(keys)
    check_cuda("keys", k, torch.uint32)
    check_cuda("table", table, table.dtype, keys.device)
    is_int = table.dtype == torch.int32
    est = keep = None
    if threshold is None:
        est = torch.empty(m, dtype=table.dtype, device=keys.device)
        thr_i, thr_f = 0, 0.0
    else:
        keep = torch.empty(m, dtype=torch.bool, device=keys.device)
        thr_i = _int_threshold(threshold) if is_int else 0
        thr_f = 0.0 if is_int else float(threshold)
    if m:
        CMS_QUERY.launch(keys.device, ptr(table), ptr(k),
                         None if est is None else ptr(est),
                         None if keep is None else ptr(keep), m, rows, width,
                         seed & 0xFFFFFFFF, fam, int(is_int), thr_i, thr_f,
                         grid_for(m, keys.device))
    return est if threshold is None else keep
