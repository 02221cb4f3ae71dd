"""Columnar tables, typed column encodings and the Big Data benchmark's
table generators.

Columns are flat tensors on one device, or typed columns:

``PlainColumn``  a decoded flat column (what raw tensors are wrapped as).
``DictColumn``   uint32 codes + a sorted ``core.encoding.DictEncoding``;
                 ``code_stream()`` hands the engine the codes and the
                 descriptor, so pass 1 prunes in code space and only
                 survivors are decoded (``Table.gather_decoded``).
``RLEColumn``    run values + int32 run lengths, the run values optionally
                 dictionary-coded; ``code_stream()`` expands to the flat
                 layout for the engine (run-level pruning without expansion
                 is ``kernels.ops.rle_*``).

The generators draw from ``np.random.default_rng(seed)`` in the same order as
the JAX package's, so the same seed gives the same columns bit for bit, and
then move them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.encoding import (DictEncoding, as_x32, dict_encode,
                             rle_encode, rle_expand, take_rows)
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class PlainColumn:
    """A decoded flat column (the identity encoding)."""

    values: torch.Tensor

    @property
    def num_rows(self) -> int:
        return int(self.values.shape[0])

    def code_stream(self):
        """(engine stream, encoding descriptor or None)."""
        return self.values, None

    def decoded(self) -> torch.Tensor:
        return self.values

    def take(self, idx) -> torch.Tensor:
        """Decoded rows at ``idx``."""
        return take_rows(self.values,
                       torch.as_tensor(idx, device=self.values.device))


@dataclasses.dataclass(frozen=True)
class DictColumn:
    """Dictionary-encoded column: ``decoded = encoding.lut[codes]``."""

    codes: torch.Tensor       # uint32[m]
    encoding: DictEncoding

    @property
    def num_rows(self) -> int:
        return int(self.codes.shape[0])

    def code_stream(self):
        return self.codes, self.encoding

    def decoded(self) -> torch.Tensor:
        return self.encoding.decode(self.codes)

    def take(self, idx) -> torch.Tensor:
        # gather the codes first: only |idx| dictionary lookups happen
        return self.encoding.decode(take_rows(
            self.codes, torch.as_tensor(idx, device=self.codes.device)))


@dataclasses.dataclass(frozen=True)
class RLEColumn:
    """Run-length-encoded column: ``run_values`` repeated ``run_lengths``;
    ``encoding`` optionally dictionary-codes the run values (the common
    Parquet layout), and ``code_stream`` then expands to flat codes."""

    run_values: torch.Tensor   # [R]
    run_lengths: torch.Tensor  # int32[R]
    encoding: DictEncoding | None = None

    @property
    def num_rows(self) -> int:
        return int(self.run_lengths.sum())

    @property
    def num_runs(self) -> int:
        return int(self.run_values.shape[0])

    def code_stream(self):
        return (rle_expand(self.run_values, self.run_lengths,
                           total=self.num_rows), self.encoding)

    def decoded(self) -> torch.Tensor:
        flat, enc = self.code_stream()
        return flat if enc is None else enc.decode(flat)

    def take(self, idx) -> torch.Tensor:
        flat = self.decoded()
        return take_rows(flat, torch.as_tensor(idx, device=flat.device))


Column = PlainColumn | DictColumn | RLEColumn


def as_column(v) -> Column:
    """Wrap a raw tensor as PlainColumn; pass typed columns through."""
    if isinstance(v, (PlainColumn, DictColumn, RLEColumn)):
        return v
    return PlainColumn(values=as_x32(v))


def dict_column(values) -> DictColumn:
    """A DictColumn of ``values`` (a tensor, on its device, or numpy)."""
    codes, enc = dict_encode(values)
    return DictColumn(codes=codes, encoding=enc)


def rle_column(values, dictionary: bool = False) -> RLEColumn:
    """An RLEColumn of ``values``; ``dictionary`` codes the run values."""
    rv, rl = rle_encode(values)
    if not dictionary:
        return RLEColumn(run_values=rv, run_lengths=rl)
    codes, enc = dict_encode(rv)
    return RLEColumn(run_values=codes, run_lengths=rl, encoding=enc)


@dataclasses.dataclass
class Table:
    name: str
    cols: dict  # str -> torch.Tensor [m] or PlainColumn/DictColumn/RLEColumn

    @classmethod
    def from_numpy(cls, name: str, cols: dict, device=None) -> "Table":
        """A table of numpy columns moved to ``device`` (None: the card)."""
        dev = resolve_device(device)
        return cls(name, {
            k: as_x32(torch.from_numpy(np.ascontiguousarray(v))).to(dev)
            for k, v in cols.items()})

    @property
    def num_rows(self) -> int:
        return as_column(next(iter(self.cols.values()))).num_rows

    def col(self, name: str) -> Column:
        """The typed column (raw tensors wrapped as PlainColumn)."""
        return as_column(self.cols[name])

    def decoded_cols(self) -> dict:
        return {k: as_column(v).decoded() for k, v in self.cols.items()}

    def encode(self, *names: str, rle: bool = False) -> "Table":
        """A new Table with ``names`` dictionary- (or RLE over dictionary-)
        encoded, on the device the columns live on."""
        cols = dict(self.cols)
        for n in names:
            v = as_column(cols[n]).decoded()
            cols[n] = (rle_column(v, dictionary=True) if rle
                       else dict_column(v))
        return Table(self.name, cols)

    def gather_decoded(self, keep) -> dict:
        """Only the surviving rows of every column, decoded: ``keep`` is a
        bool[m] mask (an engine keep mask) or an index tensor; an encoded
        column decodes just the gathered codes."""
        keep = torch.as_tensor(keep)
        idx = (torch.nonzero(keep).flatten() if keep.dtype == torch.bool
               else keep)
        return {k: as_column(v).take(idx) for k, v in self.cols.items()}


def make_products_ratings(device=None) -> tuple[Table, Table]:
    """The paper's Table 1 running example (dictionary-encoded names).

    name ids: Burger=1 Pizza=2 Fries=3 Jello=4 Cheetos=5; seller ids:
    McCheetah=1 Papizza=2 JellyFish=3."""
    dev = resolve_device(device)
    products = Table.from_numpy("products", {
        "name": np.array([1, 2, 3, 4], np.uint32),
        "seller": np.array([1, 2, 1, 3], np.uint32),
        "price": np.array([4, 7, 2, 5], np.int32),
    }, dev)
    ratings = Table.from_numpy("ratings", {
        "name": np.array([2, 5, 4, 1, 3], np.uint32),
        "taste": np.array([7, 8, 9, 5, 3], np.int32),
        "texture": np.array([5, 6, 4, 7, 3], np.int32),
    }, dev)
    return products, ratings


def make_uservisits(m: int, seed: int = 0, num_ips: int | None = None,
                    num_langs: int = 64, device=None) -> Table:
    """Big Data benchmark uservisits: sourceIP, destURL, adRevenue, lang,
    duration. ``source_ip`` is zipf(1.3) over ``num_ips`` values (heavy
    hitters for DISTINCT)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    num_ips = num_ips or max(m // 10, 16)
    ranks = rng.zipf(1.3, m).astype(np.int64) % num_ips
    return Table.from_numpy("uservisits", {
        "source_ip": ranks.astype(np.uint32),
        "dest_url": rng.integers(0, max(m // 5, 8), m).astype(np.uint32),
        "ad_revenue": rng.gamma(2.0, 50.0, m).astype(np.float32) + 1.0,
        "lang": rng.integers(0, num_langs, m).astype(np.uint32),
        "duration": rng.integers(1, 1000, m).astype(np.int32),
    }, dev)


def make_rankings(m: int, seed: int = 1, device=None) -> Table:
    """Big Data benchmark rankings: pageURL, pageRank, avgDuration."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return Table.from_numpy("rankings", {
        "page_url": rng.permutation(m).astype(np.uint32),
        "page_rank": (rng.pareto(1.5, m) * 10 + 1).astype(np.float32),
        "avg_duration": rng.integers(1, 500, m).astype(np.int32),
    }, dev)
