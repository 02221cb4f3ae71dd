"""The port's self-tuning planner and its entry points against the JAX
package's.

S comes from a measured merge cost, so both packages are given the same
cost (``calibrate_merge_cost`` replaced in both by one that returns the
true state bytes and the cost that makes ``optimal_shards`` pick S); the
reference's planner calls take ``max_devices=1`` (the test platform has 8
CPU devices; the port's default on the CPU is one position, and its mesh
plans are held in ``test_torch_mesh_layers.py``). Then, with tolerance 0:

* ``analytic_plan`` and ``candidate_plans`` give the reference's plans;
* every candidate's ``execute_plan`` keep is the reference's, bit for bit;
* ``tune`` with the same injected timings (``measure`` or ``MEASURE_HOOK``)
  gives the reference's winner, timings, incumbent and best times and
  source, through the exit gate, a zero budget, a too-short stream, the
  probe bound, corrupt and unusable cached plans and cache hits, and its
  report's counters are the reference's but for ``compile_count``;
* ``engine_prune``, ``run_query`` and ``run_queries`` at ``tune="race"``
  then ``"cached"`` give the reference's keeps and answers (S prime and
  above 8, so the reference's own plans run two_pass too).
"""
import pathlib

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import plancache as jpc
from repro.core import planner as jplanner
from repro.core.encoding import dict_encode as jdict_encode
from repro.query import QuerySpec as JSpec
from repro.query import run_queries as jrun_queries
from repro.query import run_query as jrun_query
from repro.query import workloads as jw
from repro_torch import core as T
from repro_torch import obs as tobs
from repro_torch.core import engine as tengine
from repro_torch.core import plancache as tpc
from repro_torch.core import planner as tplanner
from repro_torch.core.encoding import dict_encode as tdict_encode
from repro_torch.obs import report as tobsreport
from repro_torch.query import QuerySpec as TSpec
from repro_torch.query import run_queries as trun_queries
from repro_torch.query import run_query as trun_query
from repro_torch.query import workloads as tw

SMALL = 1511   # prime: every lane count leaves a padded tail
CHUNKED = 8209  # at S = 2 a lane is past 4096: incumbent and 1024 chunks
ALGOS = ("topn_det", "topn_rand", "distinct", "distinct fifo", "skyline",
         "groupby", "having")
_REAL_CAL = tengine.calibrate_merge_cost
_BEDS: dict = {}
_STATE_BYTES: dict = {}


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


def _bed(name, m=SMALL):
    """(JAX streams, port streams, params) of the suite's race bed for one
    algorithm form, built once a module."""
    if (name, m) not in _BEDS:
        algo = name.split()[0]
        js, p = jw.engine_streams(algo, jw.tpch_tables(scale=m, seed=0))
        ts, tp = tw.engine_streams(algo, tw.tpch_tables(scale=m, seed=0,
                                                        device="cpu"))
        assert tp == p
        if name == "distinct fifo":
            p = dict(p, policy="fifo")
        _BEDS[name, m] = (js, ts, p)
    return _BEDS[name, m]


def _torch(s):
    a = np.array(s)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


def _fix_lanes(monkeypatch, S):
    """Both packages' merge cost, fixed so that optimal_shards picks S: the
    true per-lane state bytes (the port's, which equal the reference's) and
    c = m / (S^2 · state_bytes)."""
    def cal(algo, streams, params):
        ts = tuple(s if isinstance(s, torch.Tensor) else _torch(s)
                   for s in streams)
        key = tengine._calibration_key(algo, ts, params)
        if key not in _STATE_BYTES:
            _STATE_BYTES[key] = _REAL_CAL(algo, ts, params)[1]
        sb = _STATE_BYTES[key]
        return int(ts[0].shape[0]) / (S * S * sb), sb

    monkeypatch.setattr(jengine, "calibrate_merge_cost", cal)
    monkeypatch.setattr(tengine, "calibrate_merge_cost", cal)


def _hook(monkeypatch, fn=lambda plan, thunk: 10.0):
    monkeypatch.setattr(jplanner, "MEASURE_HOOK", fn)
    monkeypatch.setattr(tplanner, "MEASURE_HOOK", fn)


def _keys(plans):
    return [p.key() for p in plans]


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------- the plans
@pytest.mark.parametrize("S", [2, 8, 13])
@pytest.mark.parametrize("name", ALGOS)
def test_plans_match(name, S, monkeypatch):
    js, ts, p = _bed(name)
    _fix_lanes(monkeypatch, S)
    want = jplanner.analytic_plan(name.split()[0], js, p, max_devices=1)
    got = tplanner.analytic_plan(name.split()[0], ts, p)
    assert got.key() == want.key() and got.shards == S
    assert _keys(tplanner.candidate_plans(name.split()[0], ts, p)) == \
        _keys(jplanner.candidate_plans(name.split()[0], js, p,
                                       max_devices=1))
    assert tplanner.analytic_plan(name.split()[0], ts, p,
                                  shards=5).key() == \
        jplanner.analytic_plan(name.split()[0], js, p, shards=5,
                               max_devices=1).key()


@pytest.mark.parametrize("name", ["distinct", "distinct fifo", "skyline"])
def test_chunked_candidates_masks_match(name, monkeypatch):
    """At S = 2 on 8209 entries a lane holds 4105: the incumbent chunks its
    pass 2 at 4096, the grid adds the whole apply and 1024 chunks; every
    candidate's keep is the incumbent's and the reference's."""
    js, ts, p = _bed(name, CHUNKED)
    algo = name.split()[0]
    _fix_lanes(monkeypatch, 2)
    plans = tplanner.candidate_plans(algo, ts, p)
    assert _keys(plans) == _keys(jplanner.candidate_plans(
        algo, js, p, max_devices=1))
    assert [q.apply_block for q in plans] == [4096, None, 1024]
    base = tengine.execute_plan(algo, *ts, plan=plans[0], **p).keep
    for plan in plans:
        got = tengine.execute_plan(algo, *ts, plan=plan, **p)
        want = jengine.execute_plan(
            algo, *js, plan=jplanner.Plan.from_dict(plan.to_dict()), **p)
        _eq(got.keep, want.keep)
        assert torch.equal(got.keep, base), plan.key()


# ------------------------------------------------------- the race itself
def _seq(*times):
    """A measure that gives the n-th raced candidate times[n], calling its
    thunk once (so each candidate's probe really runs)."""
    it = iter(times)

    def measure(plan, thunk):
        thunk()
        return next(it)

    return measure


def _outcome(res):
    return (res.plan.key(), res.source, res.timings, res.incumbent_us,
            res.best_us, res.speedup_x)


def _entries(cache):
    """The cache's entries without their clocks, keys without the device
    field."""
    return {k.rsplit("|", 1)[0]: {f: v for f, v in e.items()
                                  if f != "saved_at"}
            for k, e in cache.load().items()}


SCENARIOS = {
    "exit gate": dict(measure=(100.0, 10.0, 1.0), exit_factor=1.5),
    "no gate, last wins": dict(measure=(100.0, 80.0, 60.0),
                               exit_factor=1e9),
    "gate on the last": dict(measure=(100.0, 80.0, 50.0)),
    "slower challengers": dict(measure=(10.0, 20.0, 30.0)),
    "all tie": dict(measure=(10.0, 10.0, 10.0)),
    "zero budget": dict(measure=(50.0, 1.0, 1.0), time_budget_s=0.0),
    "hook": dict(hook=(30.0, 20.0, 25.0)),
    "no cache": dict(measure=(30.0, 20.0, 25.0), use_cache=False),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_race_matches(scenario, monkeypatch, tmp_path):
    js, ts, p = _bed("distinct", CHUNKED)
    _fix_lanes(monkeypatch, 2)
    kw = dict(SCENARIOS[scenario])
    out = {}
    for name, pl, streams in (("jax", jplanner, js), ("torch", tplanner, ts)):
        cache = (jpc if name == "jax" else tpc).PlanCache(
            tmp_path / f"{name}.json")
        times = kw.get("hook")
        if times is not None:
            monkeypatch.setattr(pl, "MEASURE_HOOK", _seq(*times))
        # probes of 2048 entries (the protocol does not depend on their
        # size), and a budget no compile of the reference's can spend,
        # except where the scenario sets one
        args = dict(dict(probe_entries=2048, time_budget_s=1e9),
                    **{k: v for k, v in kw.items() if k != "hook"})
        if "measure" in args:
            args["measure"] = _seq(*args["measure"])
        if name == "jax":
            args["max_devices"] = 1
        res = pl.tune("distinct", streams, p, cache=cache, **args)
        out[name] = (_outcome(res), _entries(cache))
    assert out["torch"] == out["jax"]
    assert out["torch"][0][1] == "race"


def test_race_on_a_too_short_stream_is_analytic(monkeypatch):
    js, ts, p = _bed("topn_det")
    _fix_lanes(monkeypatch, 2)
    boom = _seq()  # any measurement fails: nothing may be raced
    want = jplanner.tune("topn_det", tuple(s[:3] for s in js), p,
                         measure=boom, use_cache=False, max_devices=1)
    got = tplanner.tune("topn_det", tuple(s[:3] for s in ts), p,
                        measure=boom, use_cache=False)
    assert _outcome(got) == _outcome(want)
    assert got.source == "analytic" and got.plan.shards == 2


def test_probe_prefix_bounded(monkeypatch):
    """Each candidate's probe runs on max(min(m, probe_entries), S)
    entries in both packages; the winner then runs on the whole stream."""
    js, ts, p = _bed("distinct", CHUNKED)
    _fix_lanes(monkeypatch, 2)
    seen = {"jax": [], "torch": []}
    for name, eng in (("jax", jengine), ("torch", tengine)):
        real = eng.execute_plan

        def spy(algo, *streams, real=real, name=name, **kw):
            seen[name].append(int(streams[0].shape[0]))
            return real(algo, *streams, **kw)

        monkeypatch.setattr(eng, "execute_plan", spy)
    for probe in (256, 1):
        want = jplanner.tune("distinct", js, p, probe_entries=probe,
                             time_budget_s=1e9,
                             measure=_seq(3.0, 2.0, 1.0), use_cache=False,
                             max_devices=1, exit_factor=1e9)
        got = tplanner.tune("distinct", ts, p, probe_entries=probe,
                            time_budget_s=1e9,
                            measure=_seq(3.0, 2.0, 1.0), use_cache=False,
                            exit_factor=1e9)
        assert _outcome(got) == _outcome(want)
    assert seen["torch"] == seen["jax"] == [256] * 3 + [2] * 3
    full = tengine.execute_plan("distinct", *ts, plan=got.plan, **p)
    assert full.keep.shape == (CHUNKED,)


@pytest.mark.parametrize("bad", [
    dict(mode="warp_drive", shards=8), dict(mode="two_pass", shards=1),
    dict(mode="two_pass", shards=1 << 20), dict(shards=4),
    dict(mode="mesh", shards=8, num_devices=3)])
def test_unusable_cached_plan_falls_back(bad, monkeypatch, tmp_path):
    """A cached plan that does not parse, or has more lanes than the stream
    has entries, warns and races (tune) or is passed over for the analytic
    plan (resolve_plan, tune_mode="cached"), as in the reference."""
    js, ts, p = _bed("topn_det")
    _fix_lanes(monkeypatch, 13)  # the reference's cached mode spreads no S=13
    out = {}
    for name, pl, pc, streams in (("jax", jplanner, jpc, js),
                                  ("torch", tplanner, tpc, ts)):
        cache = pc.PlanCache(tmp_path / f"{name}.json")
        cache.put(pc.cache_key("topn_det", streams, p), bad)
        long = bad.get("shards") == 1 << 20
        if long:  # the cached mode passes over it without a word
            cached = pl.resolve_plan("topn_det", streams, p, "cached",
                                     cache=cache)
        else:
            with pytest.warns(UserWarning, match="unusable cached plan"):
                cached = pl.resolve_plan("topn_det", streams, p, "cached",
                                         cache=cache)
        with pytest.warns(UserWarning, match="unusable cached plan"):
            raced = pl.tune("topn_det", streams, p, cache=cache,
                            measure=_seq(10.0),
                            **({"max_devices": 1} if name == "jax" else {}))
        out[name] = (cached.source, cached.plan.key(), _outcome(raced),
                     cache.stats())
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == "analytic"


def test_cache_hit_short_circuits(monkeypatch, tmp_path):
    js, ts, p = _bed("distinct", CHUNKED)
    _fix_lanes(monkeypatch, 2)
    out = {}
    for name, pl, pc, streams in (("jax", jplanner, jpc, js),
                                  ("torch", tplanner, tpc, ts)):
        cache = pc.PlanCache(tmp_path / f"{name}.json")
        kw = {"max_devices": 1} if name == "jax" else {}
        first = pl.tune("distinct", streams, p, cache=cache,
                        time_budget_s=1e9,
                        measure=_seq(5.0, 4.0, 9.0), **kw)
        second = pl.tune("distinct", streams, p, cache=cache,
                         measure=_seq(), **kw)
        cached = pl.resolve_plan("distinct", streams, p, "cached",
                                 cache=cache)
        out[name] = [_outcome(r) for r in (first, second, cached)] + \
            [cache.stats()]
    assert out["torch"] == out["jax"]
    assert [o[1] for o in out["torch"][:3]] == ["race", "cache", "cache"]
    # a second package's file is never read for a plan: the device field
    shared = tpc.PlanCache(tmp_path / "jax.json")
    assert tplanner.resolve_plan("distinct", ts, p, "cached",
                                 cache=shared).source == "analytic"


def test_cached_miss_is_analytic_and_never_writes(monkeypatch, tmp_path):
    js, ts, p = _bed("skyline")
    _fix_lanes(monkeypatch, 13)
    got = tplanner.resolve_plan("skyline", ts, p, "cached",
                                cache=tpc.PlanCache(tmp_path / "t.json"))
    want = jplanner.resolve_plan("skyline", js, p, "cached",
                                 cache=jpc.PlanCache(tmp_path / "j.json"))
    assert _outcome(got) == _outcome(want)
    assert not any(tmp_path.iterdir())
    with pytest.raises(ValueError) as a:
        tplanner.resolve_plan("skyline", ts, p, "off")
    with pytest.raises(ValueError) as b:
        jplanner.resolve_plan("skyline", js, p, "off")
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("steps,m,S", [(("race", "race", "cached"),
                                        CHUNKED, 2),
                                       (("cached",), SMALL, 13),
                                       (("race", "cached"), SMALL, 13)])
def test_tune_report_counters_match(steps, m, S, monkeypatch, tmp_path):
    """The ``planner.tune`` reports and the registry's counters equal the
    reference's, but for ``compile_count`` (the port compiles nothing)."""
    js, ts, p = _bed("distinct", m)
    _fix_lanes(monkeypatch, S)
    _hook(monkeypatch)
    from repro import obs as jobs

    out = {}
    for name, pl, pc, obs, streams in (
            ("jax", jplanner, jpc, jobs, js),
            ("torch", tplanner, tpc, tobs, ts)):
        cache = pc.PlanCache(tmp_path / f"{name}.json")
        reports = []
        for step in steps:
            if step == "race":
                r = pl.tune("distinct", streams, p, cache=cache,
                            time_budget_s=1e9,
                            obs="counters",
                            **({"max_devices": 1} if name == "jax" else {}))
            else:
                r = pl.resolve_plan("distinct", streams, p, step,
                                    cache=cache, obs="counters")
            c = dict(r.report.counters)
            if name == "jax":
                assert c.pop("compile_count", 0) == \
                    c.get("tune_candidates", 0)
            reports.append((c, r.report.meta.get("source"),
                            r.report.meta.get("plan")))
        snap = {k: v for k, v in obs.REGISTRY.snapshot().items()
                if k.startswith(("planner.tune.", "plancache."))
                and not k.endswith("compile_count")}
        out[name] = (reports, snap)
    assert out["torch"] == out["jax"]
    assert "planner.tune.plan_cache_miss" in out["torch"][1]


# ------------------------------------------------- the entry points' knob
@pytest.mark.parametrize("tune", ["race", "cached"])
@pytest.mark.parametrize("name", ALGOS)
def test_engine_prune_tune_matches(name, tune, monkeypatch):
    js, ts, p = _bed(name)
    algo = name.split()[0]
    _fix_lanes(monkeypatch, 13)
    _hook(monkeypatch)
    for _ in range(2 if tune == "cached" else 1):  # a race, then a replay
        t = "race" if tune == "cached" and not _ else tune
        got = tengine.engine_prune(algo, *ts, tune=t, obs="off", **p)
        want = jengine.engine_prune(algo, *js, tune=t, obs="off", **p)
        _eq(got.keep, want.keep)
    plain = tengine.execute_plan(algo, *ts, plan=tplanner.Plan(shards=13),
                                 **p)
    assert torch.equal(got.keep, plain.keep)


@pytest.mark.parametrize("tune", ["race", "cached"])
def test_engine_prune_tune_on_codes(tune, monkeypatch):
    """Dictionary codes: the race runs on the codes, the plan with
    ``encoding=``; the keep is the decoded stream's and the reference's."""
    js, ts, p = _bed("distinct")
    _fix_lanes(monkeypatch, 13)
    _hook(monkeypatch)
    jc, jenc = jdict_encode(js[0])
    tc, tenc = tdict_encode(ts[0])
    for t in (("race", "cached") if tune == "cached" else ("race",)):
        got = tengine.engine_prune("distinct", tc, encoding=tenc, tune=t,
                                   **p)
        want = jengine.engine_prune("distinct", jc, encoding=jenc, tune=t,
                                    **p)
        _eq(got.keep, want.keep)
    decoded = tengine.engine_prune("distinct", *ts, tune=tune, **p)
    eager = tengine.engine_prune("distinct", tc, encoding=tenc, tune=tune,
                                 decode="eager", **p)
    assert torch.equal(got.keep, decoded.keep)
    assert torch.equal(got.keep, eager.keep)


def _specs(spec_cls):
    S = spec_cls
    return [S("topn", ("extprice",), dict(mode="det", N=16, w=4)),
            S("topn", ("extprice",), dict(d=64, w=4, N=16, seed=2)),
            S("distinct", ("orderkey",), dict(d=64, w=4)),
            S("distinct", ("orderkey",), dict(d=32, w=2, policy="fifo")),
            S("groupby", ("flag", "revenue"), dict(d=8, w=4)),
            S("having", ("flag", "revenue"),
              dict(threshold=3000.0, rows=2, width=16)),
            S("skyline", ("extprice", "quantity"), dict(w=8))]


def _same_answer(t, j):
    assert t["forwarded"] == j["forwarded"] and t["total"] == j["total"]
    _eq(t["keep"], j["keep"])
    x, y = t["output"], j["output"]
    if isinstance(y, tuple):
        for a, b in zip(x, y):
            _eq(a, b)
    elif isinstance(y, (dict, list)):
        assert x == y
    else:
        _eq(x, y)


@pytest.fixture(scope="module")
def tables():
    return (jw.make_lineitem(SMALL, seed=0),
            tw.make_lineitem(SMALL, seed=0, device="cpu"))


@pytest.mark.parametrize("i", range(7))
def test_run_query_tune_matches(i, tables, monkeypatch):
    jtab, ttab = tables
    _fix_lanes(monkeypatch, 13)
    _hook(monkeypatch)
    js, ts = _specs(JSpec)[i], _specs(TSpec)[i]
    off = trun_query(ts, ttab, obs="off")
    for tune in ("race", "cached"):
        got = trun_query(ts, ttab, tune=tune, obs="off")
        _same_answer(got, jrun_query(js, jtab, tune=tune, obs="off"))
        x, y = got["output"], off["output"]  # the answer of tune="off"
        if isinstance(y, tuple):  # TOP-N: (values, indices)
            assert all(torch.equal(a, b) for a, b in zip(x, y))
        elif isinstance(y, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("tune", ["race", "cached"])
def test_run_queries_tune_matches(tune, tables, monkeypatch):
    """Groups of two (one plan each, on the group's streams with its first
    query's parameters, through execute_plan_batch), singletons tuned
    query by query, and a FILTER that ignores the knob."""
    from repro.core.filter import Pred as JPred
    from repro_torch.core.filter import Pred as TPred

    jtab, ttab = tables
    _fix_lanes(monkeypatch, 13)
    _hook(monkeypatch)
    base = _specs(JSpec)
    mk = [(base[i], dict(base[i].params)) for i in (0, 2, 4)] + \
        [(base[2], dict(d=16, w=3, seed=5)), (base[4], dict(d=4, w=2, seed=1))]
    specs = {"jax": [], "torch": []}
    for name, S, pred in (("jax", JSpec, JPred), ("torch", TSpec, TPred)):
        for s, prm in mk:
            specs[name].append(S(s.kind, s.columns, prm))
        specs[name].append(S("filter", ("quantity",),
                             dict(formula=pred("quantity", "lt", 9))))
    runs = []
    if tune == "cached":
        runs.append("race")
    runs.append(tune)
    for t in runs:
        got = trun_queries(specs["torch"], ttab, tune=t, obs="off")
        want = jrun_queries(specs["jax"], jtab, tune=t, obs="off")
        for a, b in zip(got, want):
            _same_answer(a, b)
    off = trun_queries(specs["torch"], ttab, obs="off")
    for a, b in zip(got, off):
        if isinstance(b["output"], (dict, list)):
            assert a["output"] == b["output"]


def test_execute_plan_batch_is_execute_plan_query_by_query(tables,
                                                          monkeypatch):
    jtab, ttab = tables
    for algo, cols, qs in (
            ("distinct", ("orderkey",),
             [dict(d=64, w=4, policy="lru"), dict(d=32, w=2, policy="lru",
                                                  seed=3)]),
            ("groupby", ("flag", "revenue"),
             [dict(d=8, w=4, agg="sum"), dict(d=4, w=2, agg="sum",
                                              seed=1)])):
        ts = tuple(ttab.cols[c] for c in cols)
        js = tuple(jtab.cols[c] for c in cols)
        for plan in (dict(shards=13), dict(shards=2, apply_block=256)):
            rb = T.execute_plan_batch(algo, qs, *ts,
                                      plan=tplanner.Plan(**plan))
            jb = jengine.execute_plan_batch(algo, qs, *js,
                                            plan=jplanner.Plan(**plan))
            _eq(rb.keep, jb.keep)
            for q, k in zip(qs, rb.keep):
                one = T.execute_plan(algo, *ts, plan=tplanner.Plan(**plan),
                                     **q)
                assert torch.equal(k, one.keep)


# --------------------------------------------------------- the refusals
def test_tune_refusals_match(monkeypatch):
    js, ts, p = _bed("topn_det")
    msgs = []
    for eng, streams in ((tengine, ts), (jengine, js)):
        with pytest.raises(ValueError) as e:
            eng.engine_prune("topn_det", *streams, tune="always", **p)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    t = TSpec("topn", ("extprice",), dict(mode="det", N=4))
    for kw in (dict(tune="race", mesh=object()), dict(tune="sometimes")):
        for run, spec, tab in ((trun_query, t, tw.make_lineitem(
                64, device="cpu")), (jrun_query, JSpec(*vars(t).values()),
                                      jw.make_lineitem(64))):
            with pytest.raises(ValueError, match="tune"):
                run(spec, tab, **kw)
    with pytest.raises(ValueError, match="tune"):
        T.engine_prune_batch("topn_det", [p], *ts,
                             options=T.ExecOptions(tune="race"))
    # as in the reference, engine_prune's tune= runs the tuned plan and does
    # not read mesh=
    a = tengine.engine_prune("topn_det", *ts, mesh=T.Mesh(("cpu",) * 2),
                             tune="race", **p)
    assert torch.equal(a.keep, tengine.engine_prune(
        "topn_det", *ts, tune="race", **p).keep)


def test_tune_refuses_a_compiling_caller(monkeypatch):
    """The reference refuses traced streams; the port refuses while
    torch.compile traces the caller, with the reference's messages."""
    _, ts, p = _bed("topn_det")
    monkeypatch.setattr(tobsreport, "_compiling", lambda: True)
    with pytest.raises(ValueError, match="concrete streams — call it "
                                         "outside jit"):
        tplanner.tune("topn_det", ts, p, use_cache=False)
    with pytest.raises(ValueError, match="needs concrete streams"):
        tengine.engine_prune("topn_det", *ts, tune="race", **p)


def test_no_refusal_names_the_tuning_item():
    src = pathlib.Path(tengine.__file__).resolve().parents[1]
    hits = [f"{f.name}:{i}" for f in sorted(src.rglob("*.py"))
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if "item 11" in line]
    assert not hits
