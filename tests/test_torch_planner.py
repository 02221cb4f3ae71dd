"""The port's analytic planner and ``shards="auto"`` against the JAX package.

Every analytic function of ``repro_torch.core.planner`` equals
``repro.core.planner``'s on a grid of inputs (exact: both are the same
arithmetic in Python floats). ``calibrate_merge_cost``'s per-lane state bytes
equal the reference's for all seven algorithm forms, and ``shards="auto"``
with the measured constant fixed to the same value in both packages gives
the reference's lane count and keep mask, bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import planner as jp
from repro_torch import obs as tobs
from repro_torch.core import engine as tengine
from repro_torch.core import planner as tp


@pytest.fixture(autouse=True)
def _reset_port():
    """The port's process-wide caches and telemetry, reset around each test
    (the shared conftest resets the JAX package's)."""
    tengine.reset_caches()
    tobs.REGISTRY.reset()
    tobs.TRACER.reset()
    yield
    tengine.reset_caches()
    tobs.REGISTRY.reset()
    tobs.TRACER.reset()


def _same(a, b):
    """Equal dataclass results of the two packages: field by field, nested
    dataclasses and tuples of them included."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


FOOTPRINTS = [
    ("distinct_fifo", dict(d=4096, w=4)),
    ("distinct_fifo", dict(d=64, w=40)),
    ("distinct_lru", dict(d=4096, w=4)),
    ("skyline_sum", dict(D=2, w=8)),
    ("skyline_sum", dict(D=5, w=3)),
    ("skyline_aph", dict(D=2, w=8)),
    ("skyline_aph", dict(D=1, w=20)),
    ("topn_det", dict(w=8)),
    ("topn_rand", dict(d=512, w=8)),
    ("groupby", dict(d=4096, w=4)),
    ("join_bf", dict(M=1 << 20, H=3)),
    ("having", dict(d=3, w=1024)),
    ("having", dict(d=14, w=64)),
    ("filter", dict()),
    ("filter", dict(num_predicates=5)),
]
PROFILES = [None, dict(stages=20, alus_per_stage=4,
                       sram_per_stage_bytes=1 << 16, tcam_entries=100)]


@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("algo,p", FOOTPRINTS)
def test_footprint_and_rule_count(algo, p, prof):
    jprof = None if prof is None else jp.SwitchProfile(**prof)
    tprof = None if prof is None else tp.SwitchProfile(**prof)
    _same(tp.footprint(algo, tprof, **p), jp.footprint(algo, jprof, **p))
    assert tp.rule_count(algo, **p) == jp.rule_count(algo, **p)


def test_footprint_refusals():
    for mod in (jp, tp):
        with pytest.raises(KeyError):
            mod.footprint("median", d=1, w=1)
        with pytest.raises(ValueError):
            mod.footprint("distinct_fifo", mod.SwitchProfile(
                same_stage_shared_memory=False), d=4, w=4)
    assert tp.rule_count("median") == jp.rule_count("median")


WORKLOADS = [
    {"distinct": dict(algo="distinct_fifo", d=4096, w=4),
     "topn": dict(algo="topn_rand", d=512, w=8),
     "filter": dict(algo="filter", num_predicates=3)},
    {"sky": dict(algo="skyline_aph", D=2, w=8),
     "having": dict(algo="having", d=3, w=4096),
     "join": dict(algo="join_bf", M=1 << 18, H=3)},
    {"lru": dict(algo="distinct_lru", d=1 << 16, w=12)},
    {"a": dict(algo="topn_det", w=4), "b": dict(algo="topn_det", w=4),
     "c": dict(algo="groupby", d=256, w=3)},
]


def _fps(mod, wl):
    return {name: mod.footprint(q["algo"], **{k: v for k, v in q.items()
                                              if k != "algo"})
            for name, q in wl.items()}


@pytest.mark.parametrize("prof", PROFILES)
@pytest.mark.parametrize("wi", range(len(WORKLOADS)))
def test_pack_queries(wi, prof):
    wl = WORKLOADS[wi]
    jprof = None if prof is None else jp.SwitchProfile(**prof)
    tprof = None if prof is None else tp.SwitchProfile(**prof)
    _same(tp.pack_queries(_fps(tp, wl), tprof),
          jp.pack_queries(_fps(jp, wl), jprof))


@pytest.mark.parametrize("pass2", [None, "master", "mesh", "auto"])
@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("shards", [1, 8, 333])
@pytest.mark.parametrize("wi", range(len(WORKLOADS)))
def test_plan_multi_switch(wi, shards, ndev, pass2):
    wl = WORKLOADS[wi]
    m = 1 << 22
    _same(tp.plan_multi_switch(_fps(tp, wl), m, shards, ndev=ndev,
                               pass2=pass2),
          jp.plan_multi_switch(_fps(jp, wl), m, shards, ndev=ndev,
                               pass2=pass2))


def test_plan_multi_switch_refusals():
    for mod in (jp, tp):
        with pytest.raises(ValueError):
            mod.plan_multi_switch(_fps(mod, WORKLOADS[0]), 100, 0)
        with pytest.raises(ValueError):
            mod.pass2_time(100, 2, 10, "nowhere")


@pytest.mark.parametrize("m", [1 << 10, 1 << 17, 1 << 20, 1 << 25])
@pytest.mark.parametrize("ndev", [1, 2, 8])
@pytest.mark.parametrize("state_bytes", [0, 4096, 1 << 20])
def test_pass2_placement(m, ndev, state_bytes):
    for place in ("master", "mesh"):
        for kw in ({}, dict(apply_entry_cost=0.25, broadcast_byte_cost=0.5,
                            resident_overhead=10.0)):
            assert tp.pass2_time(m, ndev, state_bytes, place, **kw) == \
                jp.pass2_time(m, ndev, state_bytes, place, **kw)
    assert tp.optimal_pass2(m, ndev, state_bytes) == \
        jp.optimal_pass2(m, ndev, state_bytes)
    assert tp.optimal_pass2(m, ndev, state_bytes, apply_entry_cost=3.0,
                            resident_overhead=0.0) == \
        jp.optimal_pass2(m, ndev, state_bytes, apply_entry_cost=3.0,
                         resident_overhead=0.0)


BATCHES = [((), None), ((10, 20, 30), None), ((10, 20, 30), 35),
           ((50, 5, 5, 60, 1), 40), ((7,) * 9, 21), ((100,), 10)]


@pytest.mark.parametrize("bi", range(len(BATCHES)))
def test_plan_query_batch(bi):
    per, budget = BATCHES[bi]
    t = tp.plan_query_batch(per, budget)
    j = jp.plan_query_batch(per, budget)
    _same(t, j)
    assert t.num_waves == j.num_waves
    hash(t)
    for mod in (jp, tp):
        with pytest.raises(ValueError):
            mod.plan_query_batch((1, 2), 0)


@pytest.mark.parametrize("m", [1, 1000, 1 << 20, 1 << 25])
@pytest.mark.parametrize("state_bytes", [0, 64, 16384, 1 << 20])
@pytest.mark.parametrize("cost", [None, 1e-4, 0.05, 3.0])
def test_optimal_shards(m, state_bytes, cost):
    assert tp.optimal_shards(m, state_bytes, merge_byte_cost=cost) == \
        jp.optimal_shards(m, state_bytes, merge_byte_cost=cost)
    assert tp.optimal_shards(m, state_bytes, max_shards=64,
                             merge_byte_cost=cost) == \
        jp.optimal_shards(m, state_bytes, max_shards=64,
                          merge_byte_cost=cost)


def test_optimal_shards_reads_the_measured_cost(monkeypatch):
    for mod in (jp, tp):
        monkeypatch.setitem(mod.MEASURED_MERGE_COSTS, "distinct", 0.02)
    for algo in ("distinct", "topn_rand", None):
        assert tp.optimal_shards(1 << 20, 4096, algo=algo) == \
            jp.optimal_shards(1 << 20, 4096, algo=algo)


@pytest.mark.parametrize("b", [0, 1, 256, 1 << 14, 1 << 20])
@pytest.mark.parametrize("merge", [0.0, 10.0, 1e4, 1e7])
@pytest.mark.parametrize("rate", [tp.DEFAULT_STALENESS_RATE, 0.0, 0.1])
def test_optimal_merge_interval(b, merge, rate):
    assert tp.optimal_merge_interval(b, merge, rate) == \
        jp.optimal_merge_interval(b, merge, rate)
    assert tp.optimal_merge_interval(b, merge, rate, ship_entry_cost=2.0,
                                     max_interval=8) == \
        jp.optimal_merge_interval(b, merge, rate, ship_entry_cost=2.0,
                                  max_interval=8)


def test_constants():
    assert tp.DEFAULT_STALENESS_RATE == jp.DEFAULT_STALENESS_RATE
    assert tp.MAX_MERGE_INTERVAL == jp.MAX_MERGE_INTERVAL
    assert tp.RESIDENT_OVERHEAD_ENTRIES == jp.RESIDENT_OVERHEAD_ENTRIES
    assert tp._MERGE_BYTE_COST == jp._MERGE_BYTE_COST
    assert tp.SwitchProfile() == tp.SwitchProfile()
    assert dataclasses.astuple(tp.SwitchProfile()) == \
        dataclasses.astuple(jp.SwitchProfile())


# ------------------------------------------- calibration and shards="auto"
def _case(name, seed=0, m=2001):
    """(algo, numpy streams, params) of one of the seven algorithm forms."""
    rs = np.random.default_rng(seed)
    if name == "topn_det":
        return "topn_det", ((rs.random(m) * 1e5 + 1).astype(np.float32),), \
            dict(N=25, w=6)
    if name == "topn_rand":
        return "topn_rand", ((rs.random(m) * 1e5).astype(np.float32),), \
            dict(d=64, w=8, seed=seed)
    if name in ("distinct_lru", "distinct_fifo"):
        return "distinct", (rs.integers(1, 250, m).astype(np.uint32),), \
            dict(d=32, w=4, policy=name.split("_")[1])
    if name == "skyline":
        return "skyline", (rs.integers(1, 400, (m, 3)).astype(np.float32),), \
            dict(w=8)
    keys = rs.integers(0, 40, m).astype(np.uint32)
    vals = rs.integers(1, 50, m).astype(np.int32)
    if name == "groupby":
        return "groupby", (keys, vals), dict(d=16, w=4, agg="sum")
    assert name == "having"
    return "having", (keys, vals), dict(threshold=150, rows=3, width=256)


NAMES = ("topn_det", "topn_rand", "distinct_lru", "distinct_fifo", "skyline",
         "groupby", "having")
# more parameter sets, each changing a state's shape or dtype
VARIANTS = [
    ("topn_rand", dict(d=7, w=3)),
    ("distinct_fifo", dict(d=100, w=2)),
    ("skyline", dict(w=3, score="sum")),
    ("groupby", dict(d=5, w=6, agg="count")),
    ("having", dict(agg="count", rows=2, width=64)),
    ("topn_det", dict(w=9)),
]


def _jkey(algo, streams, params):
    """The JAX package's calibration key (``engine.calibrate_merge_cost``)."""
    return (algo,
            tuple((str(s.dtype), tuple(s.shape[1:])) for s in streams),
            tuple(sorted((k, v) for k, v in params.items()
                         if isinstance(v, (int, float, str, bool)))))


@pytest.mark.parametrize("name,extra", [(n, {}) for n in NAMES] + VARIANTS)
def test_calibrated_state_bytes_match(name, extra):
    algo, xs, p = _case(name)
    p = dict(p, **extra)
    jc, jsb = jengine.calibrate_merge_cost(
        algo, tuple(jnp.asarray(x) for x in xs), p)
    tc, tsb = tengine.calibrate_merge_cost(
        algo, tuple(torch.from_numpy(x) for x in xs), p)
    assert tsb == jsb
    assert tc > 0 and np.isfinite(tc)
    assert tp.MEASURED_MERGE_COSTS[algo] == tc
    # cached: a second call measures nothing
    assert tengine.calibrate_merge_cost(
        algo, tuple(torch.from_numpy(x) for x in xs), p) == (tc, tsb)
    tengine.reset_caches()
    assert not tp.MEASURED_MERGE_COSTS and not tengine._CALIBRATION


@pytest.mark.parametrize("name,c", [(n, (1e-3, 3e-2)[i % 2])
                                    for i, n in enumerate(NAMES)])
def test_auto_shards_match_with_the_calibration_fixed(name, c, monkeypatch):
    """S depends on the measured constant, so both packages are given the
    same (c, state_bytes): the resolved S and the mask must then agree."""
    algo, xs, p = _case(name, seed=1)
    jx = tuple(jnp.asarray(x) for x in xs)
    tx = tuple(torch.from_numpy(x) for x in xs)
    _, sb = jengine.calibrate_merge_cost(algo, jx, p)
    monkeypatch.setitem(jengine._CALIBRATION, _jkey(algo, jx, p), (c, sb))
    monkeypatch.setitem(tengine._CALIBRATION,
                        tengine._calibration_key(algo, tx, p), (c, sb))
    for mode in ("sharded", "two_pass"):
        want = jengine.engine_prune(algo, *jx, mode=mode, shards="auto",
                                    obs="counters", **p)
        got = tengine.engine_prune(algo, *tx, mode=mode, shards="auto",
                                   obs="counters", **p)
        s = jp.optimal_shards(xs[0].shape[0], sb, merge_byte_cost=c)
        assert got.report.meta["shards"] == want.report.meta["shards"] \
            == min(s, xs[0].shape[0])
        np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
        again = tengine.engine_prune(algo, *tx, mode=mode,
                                     shards=got.report.meta["shards"], **p)
        np.testing.assert_array_equal(got.keep.numpy(), again.keep.numpy())
    scan = tengine.engine_prune(algo, *tx, mode="scan", shards="auto",
                                obs="counters", **p)
    assert scan.report.meta["shards"] == 1
