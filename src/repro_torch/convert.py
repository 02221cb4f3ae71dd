"""Carry the JAX package's outputs (as numpy arrays) into the port's objects.

Each function takes numpy arrays and a device (``None``: the card, which
raises RuntimeError when there is none).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.distinct import DistinctState
from .core.encoding import DictEncoding
from .core.engine import TopNDetMerged
from .core.groupby import GroupByState
from .core.sketches import BloomFilter, CountMin
from .core.skyline import SkylineState
from .core.topn import TopNDetState, TopNRandState
from .device import resolve_device
from .kernels.bloom_filter import pack_bits
from .query.tables import DictColumn, RLEColumn, Table


def _t(a, dtype: np.dtype, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype)).to(dev)


def topn_rand_state_from_numpy(vals, device=None) -> TopNRandState:
    """A TOP-N matrix f32[d, w] (or stacked [S, d, w])."""
    return TopNRandState(vals=_t(vals, np.float32, resolve_device(device)))


def topn_det_state_from_numpy(t0=None, counts=None, seen=None,
                              cur_level=None, *, threshold=None,
                              device=None) -> TopNDetState | TopNDetMerged:
    """A threshold ladder: f32 t0, int32 counts[w], seen and cur_level (or
    stacked [S], [S, w]); with ``threshold=`` instead, the merged state of
    two_pass (``TopNDetMerged``, an f32 scalar)."""
    dev = resolve_device(device)
    if threshold is not None:
        return TopNDetMerged(threshold=_t(threshold, np.float32, dev))
    return TopNDetState(t0=_t(t0, np.float32, dev),
                        counts=_t(counts, np.int32, dev),
                        seen=_t(seen, np.int32, dev),
                        cur_level=_t(cur_level, np.int32, dev))


def dict_encoding_from_numpy(lut, pad_slot: bool = False,
                             device=None) -> DictEncoding:
    """A ``DictEncoding`` of the sorted dictionary ``lut`` (in its own
    dtype)."""
    lut = np.asarray(lut)
    return DictEncoding(lut=_t(lut, lut.dtype, resolve_device(device)),
                        pad_slot=pad_slot)


def dict_column_from_numpy(codes, lut, device=None) -> DictColumn:
    """A ``DictColumn``: uint32 codes and their dictionary."""
    dev = resolve_device(device)
    return DictColumn(codes=_t(codes, np.uint32, dev),
                      encoding=dict_encoding_from_numpy(lut, device=dev))


def rle_column_from_numpy(run_values, run_lengths, lut=None,
                          device=None) -> RLEColumn:
    """An ``RLEColumn``: run values (uint32 codes when ``lut`` is given, in
    their own dtype otherwise) and int32 run lengths."""
    dev = resolve_device(device)
    rv = np.asarray(run_values)
    return RLEColumn(
        run_values=_t(rv, np.uint32 if lut is not None else rv.dtype, dev),
        run_lengths=_t(run_lengths, np.int32, dev),
        encoding=None if lut is None else dict_encoding_from_numpy(
            lut, device=dev))


def distinct_state_from_numpy(slots, valid, head, device=None) -> DistinctState:
    """A DISTINCT cache: uint32 slots, bool valid, int32 head."""
    dev = resolve_device(device)
    return DistinctState(slots=_t(slots, np.uint32, dev),
                         valid=_t(valid, np.bool_, dev),
                         head=_t(head, np.int32, dev))


def distinct_kernel_state_from_numpy(lo, hi, valid, device=None):
    """(slots uint32, valid bool) from a Pallas DISTINCT kernel's state, which
    carries each fingerprint as two exact f32 16-bit halves and valid as
    f32 0/1."""
    dev = resolve_device(device)
    lo = np.asarray(lo, np.float32).astype(np.uint32)
    hi = np.asarray(hi, np.float32).astype(np.uint32)
    return (_t(lo + (hi << np.uint32(16)), np.uint32, dev),
            _t(np.asarray(valid) > 0.5, np.bool_, dev))


def skyline_state_from_numpy(points, scores, device=None) -> SkylineState:
    """A SKYLINE store: points f32[w, D] and scores f32[w] (or a merged
    [S*w, D] + [S*w] set, or stacked [S, w, D] + [S, w])."""
    dev = resolve_device(device)
    return SkylineState(points=_t(points, np.float32, dev),
                        scores=_t(scores, np.float32, dev))


def groupby_state_from_numpy(keys, aggs, valid, device=None) -> GroupByState:
    """A GROUP BY cache: uint32 keys, f32 aggregates and bool valid flags
    [d, w] (or stacked [S, d, w])."""
    dev = resolve_device(device)
    return GroupByState(keys=_t(keys, np.uint32, dev),
                        aggs=_t(aggs, np.float32, dev),
                        valid=_t(valid, np.bool_, dev))


def count_min_from_numpy(table, seed: int = 0, device=None) -> CountMin:
    """A Count-Min sketch: an int32 or f32 table [rows, width] (or stacked
    [S, rows, width]), in its own dtype."""
    table = np.asarray(table)
    if table.dtype not in (np.int32, np.float32):
        raise TypeError(f"a Count-Min table is int32 or float32, got "
                        f"{table.dtype}")
    return CountMin(table=_t(table, table.dtype, resolve_device(device)),
                    seed=seed)


def bloom_filter_from_numpy(bits, num_hashes: int = 3, seed: int = 0,
                            device=None) -> BloomFilter:
    """A Bloom filter from its bool[nbits] bits (``BloomFilter.bits`` of the
    JAX package), packed into uint32 words."""
    bits = _t(np.asarray(bits) != 0, np.bool_, resolve_device(device))
    return BloomFilter(words=pack_bits(bits), nbits=int(bits.shape[0]),
                       num_hashes=num_hashes, seed=seed)


def groupby_state_from_numpy(keys, aggs, valid, device=None) -> GroupByState:
    """A GROUP BY cache: uint32 keys, f32 aggregates, bool valid [d, w] (or
    stacked [S, d, w], merged [d, S*w])."""
    dev = resolve_device(device)
    return GroupByState(keys=_t(keys, np.uint32, dev),
                        aggs=_t(aggs, np.float32, dev),
                        valid=_t(valid, np.bool_, dev))


def table_from_numpy(cols: dict, name: str = "table", device=None) -> Table:
    """A Table of the given numpy columns on ``device``."""
    return Table.from_numpy(name, cols, device)


def _map_tree(fn, tree: dict) -> dict:
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _lm_leaf(a, dev: torch.device) -> torch.Tensor:
    """One leaf of a parameter tree: bf16 arrives as its uint16 bits."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """A ``models.LM`` of ``cfg`` holding the reference's parameter tree
    (``repro.models.LM(cfg).init(key)[0]`` as nested dicts of numpy arrays;
    bf16 leaves as their uint16 bit patterns,
    ``np.asarray(a).view(np.uint16)``; f32 leaves as they are). Every path,
    shape and dtype must be the one the port's ``init`` draws."""
    from .models import LM

    dev = resolve_device(device)
    tree = _map_tree(lambda a: _lm_leaf(a, dev), tree)
    want = _leaves(LM(cfg).init(device="meta"))
    params = _leaves(tree)
    bad = sorted(set(want) ^ set(params)) + [
        f"{k}: {tuple(params[k].shape)} {params[k].dtype}, want "
        f"{tuple(w.shape)} {w.dtype}" for k, w in want.items()
        if k in params and (params[k].shape != w.shape
                            or params[k].dtype != w.dtype)]
    if bad:
        raise ValueError("the parameter tree does not fit the model: "
                         + "; ".join(bad))
    lm = LM(cfg)
    lm.load_tree(tree)
    return lm
