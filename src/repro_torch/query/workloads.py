"""TPC-H-subset workload suite: the tuning race bed and end-to-end check.

Three TPC-H-flavoured queries over a seeded lineitem / orders pair, each
with a pruned execution path through the engine (`SuiteQuery.run`, which
takes the ``tune=`` knob) and a plain-Python reference (`SuiteQuery.
reference`: dict and loop SQL semantics over the columns' Python values),
so every suite run is a differential correctness check:

``q1_pricing``  (Q1: filter + GROUP BY)
    SELECT flag, SUM(revenue) WHERE shipdate <= CUT GROUP BY flag: the
    GROUP BY pruner forwards evicted partials and its final state, the
    master folds them into the exact per-flag sums.
``q3_shipping`` (Q3: join + TOP-N)
    date-filtered orders Bloom-joined against lineitem (a superset-safe
    switch filter, the master re-checks exactly), then ORDER BY extprice
    LIMIT N through the deterministic TOP-N pruner.
``q6_forecast`` (Q6: selective aggregate)
    SUM(revenue * discount) under a 5-predicate conjunctive WHERE: the
    predicate decomposition prunes at the switch, the master applies the
    full formula and sums the survivors.

Exactness is by construction, not tolerance: ``revenue`` is an
integer-valued float32 (1..50) with per-group sums below 2^24 (each of
Q1's six flag sums is about 3.9 x ``scale``, so ``scale`` must stay below
about 4.2 M rows), so f32 addition is exact in any order; ``extprice`` is
a permutation (all values distinct, exact in f32 below 2^24), so TOP-N has
one answer; Q6 sums in int64.

The generators draw from ``np.random.default_rng(seed)`` in the JAX
package's order, so a seed gives its columns bit for bit, then move them to
``device`` (None: the card). They also back one race bed per engine
algorithm (``engine_streams``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import core
from ..core.encoding import take_rows
from ..core.hashing import as_u32
from ..device import resolve_device
from .engine import QuerySpec, run_query
from .tables import Table

# date axis spans [0, DATE_MAX); cuts chosen for TPC-H-like selectivity
DATE_MAX = 2400
Q1_SHIP_CUT = 2200        # Q1 keeps ~92% (the classic near-full scan)
Q3_ORDER_CUT = 1200       # Q3 keeps ~half the orders
Q3_LIMIT = 10
Q6_SHIP_LO, Q6_SHIP_HI = 1000, 1400   # one "year"
Q6_DISC_LO, Q6_DISC_HI = 2, 4
Q6_QTY_LT = 24


# ------------------------------------------------------------ generators
def make_lineitem(scale: int, seed: int = 0, device=None) -> Table:
    """Deterministic lineitem-like table with ``scale`` rows.

    revenue: integer-valued f32 in [1, 50] (exact f32 sums);
    extprice: a permutation of 1..scale (unique: TOP-N is unambiguous);
    flag: a returnflag/linestatus-style 6-value group key;
    discount / quantity: small ints for Q6's conjunctive predicate.
    """
    rng = np.random.default_rng(seed)
    return Table.from_numpy("lineitem", {
        "orderkey": rng.integers(0, 2 * scale, scale).astype(np.uint32),
        "shipdate": rng.integers(0, DATE_MAX, scale).astype(np.int32),
        "revenue": rng.integers(1, 51, scale).astype(np.float32),
        "extprice": (rng.permutation(scale) + 1).astype(np.float32),
        "flag": rng.integers(0, 6, scale).astype(np.uint32),
        "discount": rng.integers(0, 11, scale).astype(np.int32),
        "quantity": rng.integers(1, 51, scale).astype(np.int32),
    }, resolve_device(device))


def make_orders(scale: int, seed: int = 1, device=None) -> Table:
    """Orders-like table with ``scale`` rows; orderkey = arange, so about
    half of lineitem's [0, 2·scale) orderkeys find a real order."""
    rng = np.random.default_rng(seed)
    return Table.from_numpy("orders", {
        "orderkey": np.arange(scale, dtype=np.uint32),
        "custkey": rng.integers(0, max(scale // 3, 1),
                                scale).astype(np.uint32),
        "orderdate": rng.integers(0, DATE_MAX, scale).astype(np.int32),
    }, resolve_device(device))


def tpch_tables(scale: int = 30_000, seed: int = 0, device=None) -> dict:
    """The suite's table set: lineitem at ``scale`` rows, orders at
    scale/3 (TPC-H's ~1:3 orders:lineitem ratio, truncated)."""
    return {"lineitem": make_lineitem(scale, seed, device),
            "orders": make_orders(max(scale // 3, 8), seed + 1, device)}


def _values(t: torch.Tensor) -> list:
    """A column's Python values (uint32 by value)."""
    return (as_u32(t) if t.dtype == torch.uint32 else t).cpu().tolist()


# ------------------------------------------------------------- Q1 bodies
def _q1_run(tables, tune="off", plan_cache=None):
    li = tables["lineitem"]
    rows = torch.nonzero(li.cols["shipdate"] <= Q1_SHIP_CUT).flatten()
    scanned = Table("lineitem_q1", {
        "flag": take_rows(li.cols["flag"], rows),
        "revenue": li.cols["revenue"][rows],
    })
    r = run_query(QuerySpec("groupby", ("flag", "revenue"),
                            dict(d=8, w=4)),
                  scanned, tune=tune, plan_cache=plan_cache)
    return {int(k): float(v) for k, v in r["output"].items()}


def _q1_reference(tables):
    li = tables["lineitem"].cols
    out: dict = {}
    for f, d, r in zip(_values(li["flag"]), _values(li["shipdate"]),
                       _values(li["revenue"])):
        if d <= Q1_SHIP_CUT:
            out[f] = out.get(f, 0.0) + r
    return {int(k): float(v) for k, v in out.items()}


# ------------------------------------------------------------- Q3 bodies
def _q3_run(tables, tune="off", plan_cache=None):
    li, orders = tables["lineitem"], tables["orders"]
    odate_ok = orders.cols["orderdate"] < Q3_ORDER_CUT
    okeys = orders.cols["orderkey"]
    # switch side: Bloom filter of the surviving orderkeys, superset-safe
    ok_keys = torch.where(odate_ok, okeys.view(torch.int32),
                          -1).view(torch.uint32)
    bloom = core.bloom_build(ok_keys, 1 << 16, 3)
    join_keep = core.bloom_query(bloom, li.cols["orderkey"])
    # master side: exact membership check on the forwarded superset (the
    # keys by value in int64: the card indexes no uint32 tensor)
    li_keys = as_u32(li.cols["orderkey"])
    exact = torch.zeros_like(join_keep)
    exact[join_keep] = torch.isin(li_keys[join_keep],
                                  as_u32(okeys)[odate_ok])
    # tunable TOP-N over the joined survivors' extprice
    vals = li.cols["extprice"][exact]
    keys = li_keys[exact]
    r = _engine("topn_det", (vals,), dict(N=Q3_LIMIT, w=8),
                tune, plan_cache)
    topv, topi = core.master_complete_topn(vals, r.keep, Q3_LIMIT)
    return [(int(k), float(v))
            for v, k in zip(topv.tolist(), keys[topi].tolist())]


def _q3_reference(tables):
    li = tables["lineitem"].cols
    orders = tables["orders"].cols
    ok = {k for k, d in zip(_values(orders["orderkey"]),
                            _values(orders["orderdate"]))
          if d < Q3_ORDER_CUT}
    rows = [(k, p) for k, p in zip(_values(li["orderkey"]),
                                   _values(li["extprice"]))
            if k in ok]
    rows.sort(key=lambda kp: -kp[1])
    return [(int(k), float(p)) for k, p in rows[:Q3_LIMIT]]


# ------------------------------------------------------------- Q6 bodies
_Q6_FORMULA = core.And((
    core.Pred("shipdate", "ge", Q6_SHIP_LO),
    core.Pred("shipdate", "lt", Q6_SHIP_HI),
    core.Pred("discount", "ge", Q6_DISC_LO),
    core.Pred("discount", "le", Q6_DISC_HI),
    core.Pred("quantity", "lt", Q6_QTY_LT),
))


def _q6_run(tables, tune="off", plan_cache=None):
    # the filter pruner is stateless: there is no plan to tune, so the
    # knob is accepted (one suite API) and ignored
    li = tables["lineitem"]
    cols = {c: li.cols[c] for c in ("shipdate", "discount", "quantity")}
    pr = core.filter_prune(_Q6_FORMULA, cols)
    final = core.master_complete_filter(_Q6_FORMULA, cols, pr.keep)
    rev = li.cols["revenue"][final].to(torch.int64)
    disc = li.cols["discount"][final].to(torch.int64)
    return int((rev * disc).sum())


def _q6_reference(tables):
    li = tables["lineitem"].cols
    total = 0
    for d, disc, q, r in zip(_values(li["shipdate"]),
                             _values(li["discount"]),
                             _values(li["quantity"]),
                             _values(li["revenue"])):
        if (Q6_SHIP_LO <= d < Q6_SHIP_HI
                and Q6_DISC_LO <= disc <= Q6_DISC_HI and q < Q6_QTY_LT):
            total += int(r) * disc
    return total


def _engine(algo, streams, params, tune, plan_cache):
    """Tuned-or-analytic engine call shared by the suite bodies: with
    tune="off" the analytic plan still runs (the suite always runs the
    two-pass family, so off / cached / race differ only in speed)."""
    if tune == "off":
        plan = core.analytic_plan(algo, streams, params)
    else:
        plan = core.resolve_plan(algo, streams, params, tune_mode=tune,
                                 cache=plan_cache).plan
    return core.execute_plan(algo, *streams, plan=plan, **params)


# ---------------------------------------------------------------- suite
@dataclasses.dataclass(frozen=True)
class SuiteQuery:
    """One suite member: a pruned engine path and its plain-Python oracle.
    ``run(tables, tune=..., plan_cache=...)`` and ``reference(tables)``
    return the same normalized Python value (dict / list of tuples / int):
    compare with ==."""
    name: str
    algo: str        # engine algorithm behind the tunable stage
    run: Callable
    reference: Callable


SUITE = (
    SuiteQuery("q1_pricing", "groupby", _q1_run, _q1_reference),
    SuiteQuery("q3_shipping", "topn_det", _q3_run, _q3_reference),
    SuiteQuery("q6_forecast", "filter", _q6_run, _q6_reference),
)


def get(name: str) -> SuiteQuery:
    for q in SUITE:
        if q.name == name:
            return q
    raise KeyError(name)


# ----------------------------------------------- per-algorithm race beds
def engine_streams(algo: str, tables) -> tuple[tuple, dict]:
    """(streams, params) for racing ``algo`` on suite data: one bed per
    ``core.ALGORITHMS`` entry, all drawn from the lineitem columns."""
    li = tables["lineitem"].cols
    if algo == "topn_det":
        return (li["extprice"],), dict(N=64, w=8)
    if algo == "topn_rand":
        return (li["extprice"],), dict(d=1024, w=8, seed=0)
    if algo == "distinct":
        return (li["orderkey"],), dict(d=4096, w=4)
    if algo == "skyline":
        pts = torch.stack([li["extprice"],
                           li["quantity"].to(torch.float32)], dim=-1)
        return (pts,), dict(w=64, score="aph")
    if algo == "groupby":
        return (li["flag"], li["revenue"]), dict(d=8, w=4)
    if algo == "having":
        # shipdate >= 0: the int32 buckets' bits are their uint32 values
        bucket = (li["shipdate"] // 100).view(torch.uint32)
        return (bucket, li["revenue"]), dict(threshold=100.0, rows=3,
                                             width=1024)
    raise KeyError(algo)
