"""The port's TPC-H subset suite against the JAX package's.

The generators give the reference's columns bit for bit; every suite query
at tune off, race and cached answers exactly what the JAX package's ``run``
and both plain-Python references answer (compared with ``==``: the suite
is exact by construction), and ``engine_streams`` gives the reference's
race bed for all six algorithms, with masks identical at a fixed plan.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro.query import workloads as jw
from repro_torch import obs as tobs
from repro_torch.core import engine as tengine
from repro_torch.core import plancache as tpc
from repro_torch.core import planner as tplanner
from repro_torch.query import workloads as tw

SCALE = 1500
_JAX_RUNS: dict = {}


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


@pytest.fixture(scope="module")
def beds():
    """(JAX tables, port tables) at the reference suite's scale."""
    return (jw.tpch_tables(scale=SCALE, seed=0),
            tw.tpch_tables(scale=SCALE, seed=0, device="cpu"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int32).numpy().view(np.uint32)
                if x.dtype == torch.uint32 else x.numpy())
    return np.asarray(x)


def _same_table(jt, tt):
    assert list(tt.cols) == list(jt.cols) and tt.name == jt.name
    for c in jt.cols:
        a, b = _np(jt.cols[c]), _np(tt.cols[c])
        assert a.dtype == b.dtype and a.shape == b.shape, c
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), c


@pytest.mark.parametrize("scale,seed", [(SCALE, 0), (700, 3), (24, 1),
                                        (9, 5)])
def test_generators_match(scale, seed):
    jt_, tt_ = (jw.tpch_tables(scale, seed),
                tw.tpch_tables(scale, seed, device="cpu"))
    for name in ("lineitem", "orders"):
        _same_table(jt_[name], tt_[name])
    _same_table(jw.make_orders(scale, seed), tw.make_orders(
        scale, seed, device="cpu"))
    li = tt_["lineitem"].cols
    assert torch.unique(li["extprice"]).numel() == scale
    assert torch.equal(li["revenue"], li["revenue"].round())


def _jax_run(query, tune, jtabs, monkeypatch, tmp_path):
    """The JAX package's answer at ``tune`` (each computed once a module);
    its race replays recorded timings and keeps its plans in its own file."""
    key = (query.name, tune)
    if key not in _JAX_RUNS:
        monkeypatch.setattr(jplanner, "MEASURE_HOOK", lambda p, t: 10.0)
        from repro.core import plancache as jpc
        cache = jpc.PlanCache(tmp_path / "jax_plans.json")
        if tune == "cached":
            query.run(jtabs, tune="race", plan_cache=cache)
        _JAX_RUNS[key] = query.run(jtabs, tune=tune, plan_cache=cache)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("tune", ["off", "race", "cached"])
@pytest.mark.parametrize("name", [q.name for q in tw.SUITE])
def test_suite_query_matches(name, tune, beds, monkeypatch, tmp_path):
    jtabs, ttabs = beds
    q, jq = tw.get(name), jw.get(name)
    assert (q.name, q.algo) == (jq.name, jq.algo)
    monkeypatch.setattr(tplanner, "MEASURE_HOOK", lambda p, t: 10.0)
    cache = tpc.PlanCache(tmp_path / "plans.json")
    if tune == "cached":
        q.run(ttabs, tune="race", plan_cache=cache)
        assert len(cache.load()) == (0 if q.algo == "filter" else 1)
    got = q.run(ttabs, tune=tune, plan_cache=cache)
    want = q.reference(ttabs)
    assert want == jq.reference(jtabs)
    assert got == want
    assert got == _jax_run(jq, tune, jtabs, monkeypatch, tmp_path)
    if tune == "cached" and q.algo != "filter":
        assert cache.stats()["hits"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suite_reference_stable_across_seeds(seed):
    tabs = tw.tpch_tables(scale=700, seed=seed, device="cpu")
    for q in tw.SUITE:
        assert q.run(tabs) == q.reference(tabs), q.name


@pytest.mark.parametrize("algo", jengine.ALGORITHMS)
def test_engine_streams_match(algo, beds):
    """Each bed equals the reference's bit for bit, and the masks at one
    plan (S = 8, and a chunked pass 2 for the chunkable algorithms) equal
    the reference's."""
    jtabs, ttabs = beds
    js, jp = jw.engine_streams(algo, jtabs)
    ts, tp = tw.engine_streams(algo, ttabs)
    assert tp == jp and len(ts) == len(js)
    for a, b in zip(js, ts):
        a, b = np.asarray(a), _np(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert int(b.shape[0]) == SCALE
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    plan = dict(mode="two_pass", shards=8,
                apply_block=64 if jengine._SPECS[algo].chunkable else None)
    want = jengine.execute_plan(algo, *js, plan=jplanner.Plan(**plan), **jp)
    got = tengine.execute_plan(algo, *ts, plan=tplanner.Plan(**plan), **tp)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))


def test_engine_streams_unknown_algorithm(beds):
    for w in (jw, tw):
        with pytest.raises(KeyError):
            w.engine_streams("sort", beds[w is tw])


def test_get_by_name():
    assert tw.get("q1_pricing").algo == jw.get("q1_pricing").algo
    assert [q.name for q in tw.SUITE] == [q.name for q in jw.SUITE]
    with pytest.raises(KeyError):
        tw.get("q99")


def test_generators_need_a_device_or_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.make_lineitem(16)
    assert tw.make_orders(16, device="cpu").cols["orderkey"].device.type \
        == "cpu"
    assert jnp.asarray(jw.make_orders(16).cols["orderkey"]).shape == (16,)
