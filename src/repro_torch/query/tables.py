"""Columnar tables and the Big Data benchmark's table generators.

Columns are flat tensors (wrapped as ``PlainColumn``) on one device. The
generators draw from ``np.random.default_rng(seed)`` in the same order as
the JAX package's, so the same seed gives the same columns bit for bit, and
then move them to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class PlainColumn:
    """A decoded flat column (the identity encoding)."""

    values: torch.Tensor

    @property
    def num_rows(self) -> int:
        return int(self.values.shape[0])

    def decoded(self) -> torch.Tensor:
        return self.values

    def take(self, idx) -> torch.Tensor:
        """Decoded rows at ``idx``."""
        idx = torch.as_tensor(idx, device=self.values.device)
        if self.values.dtype == torch.uint32:
            return self.values.view(torch.int32)[idx].view(torch.uint32)
        return self.values[idx]


def as_column(v) -> PlainColumn:
    """Wrap a raw tensor as PlainColumn; pass a PlainColumn through."""
    if isinstance(v, PlainColumn):
        return v
    if isinstance(v, torch.Tensor):
        return PlainColumn(values=v)
    raise NotImplementedError(
        f"column of type {type(v).__name__} is not ported yet (ROADMAP "
        "Queue 1 item 10: encoded columns)")


@dataclasses.dataclass
class Table:
    name: str
    cols: dict  # str -> torch.Tensor [m] or PlainColumn

    @classmethod
    def from_numpy(cls, name: str, cols: dict, device=None) -> "Table":
        """A table of numpy columns moved to ``device`` (None: the card)."""
        dev = resolve_device(device)
        return cls(name, {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                          for k, v in cols.items()})

    @property
    def num_rows(self) -> int:
        return as_column(next(iter(self.cols.values()))).num_rows

    def col(self, name: str) -> PlainColumn:
        return as_column(self.cols[name])


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
