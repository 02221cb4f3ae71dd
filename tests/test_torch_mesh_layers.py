"""The layers above the mesh engine, on the port's ``Mesh(("cpu",) * 8)``,
against the JAX package's on the conftest's 8 CPU devices.

With tolerance 0:

* ``engine_prune_batch(mode="mesh")``: the resident wave's keep (stacked
  [Q, S, n]), merged states and counters are the reference's, ONE gather a
  wave (``Mesh.collectives``, and the report's ``merge_collective_count``,
  also over two admission waves); the master wave's keep is the port's
  two_pass batch; ``unshard_mask_batch`` flattens;
* a mesh ``PruneStream``: ``close()`` and the live masks are the
  reference's mesh stream's;
* ``run_query`` / ``run_queries`` with ``mesh=`` on the ``"data"`` axis:
  the reference's keep and answer (JOIN's Bloom filters ORed over the
  workers), every kind's answer the one without a mesh, and ``tune`` with a
  mesh refused as the reference refuses it;
* ``analytic_plan`` / ``candidate_plans`` at ``max_devices=8``: the
  reference's plan lists (the merge cost fixed in both packages, as in
  ``test_torch_tune.py``); every mesh plan's ``execute_plan`` keep comes
  back flat and equal to the two_pass plan's, and ``execute_plan_batch`` of
  a mesh plan flat [Q, m].
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro.core import streaming as JS
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import core as T
from repro_torch.core import engine as tengine
from repro_torch.core import planner as tplanner
from repro_torch.core import streaming as TS
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_tune import _bed, _fix_lanes, _keys  # noqa: E402

S = 16
POSITIONS = 8
M = 2001
ROWS = 1 << 12


@pytest.fixture(autouse=True)
def _reset_port():
    tengine.reset_caches()
    yield
    tengine.reset_caches()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(t, j):
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def _state_eq(tstate, jstate):
    for f in vars(jstate):
        jv = getattr(jstate, f)
        if isinstance(jv, int):
            assert getattr(tstate, f) == jv
        else:
            _eq(getattr(tstate, f), jv)


def _cpu8(axis="shards"):
    return T.Mesh(("cpu",) * POSITIONS, axis=axis)


def _jmesh(axis="shards"):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:POSITIONS]), (axis,))


# ---------------------------------------------------------------- batches
BATCHES = {
    # the reference's 2-process smoke: mixed N and w in one program
    "topn_det": [dict(N=8, w=4), dict(N=32, w=8), dict(N=16, w=6),
                 dict(N=4, w=5)],
    "distinct": [dict(d=32, w=4, policy="fifo"),
                 dict(d=16, w=2, policy="fifo", seed=3)],
}


def _batch_stream(algo):
    rng = np.random.default_rng(11)
    if algo == "topn_det":
        return (rng.random(M) * 1e6 + 1).astype(np.float32)
    return rng.integers(1, 300, M).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_batch(algo):
    x = _batch_stream(algo)
    return x, jengine.engine_prune_batch(algo, BATCHES[algo], jnp.asarray(x),
                                         mode="mesh", shards=S,
                                         mesh=_jmesh(), pass2="mesh")


@pytest.mark.parametrize("algo", list(BATCHES))
def test_batch_resident_wave_matches_the_reference(algo):
    x, jres = _jax_batch(algo)
    mesh = _cpu8()
    res = T.engine_prune_batch(algo, BATCHES[algo], torch.from_numpy(x),
                               mode="mesh", shards=S, mesh=mesh, pass2="mesh")
    assert res.keep.shape == np.shape(jres.keep) == \
        (len(BATCHES[algo]), S, -(-M // S))
    _eq(res.keep, jres.keep)
    _state_eq(res.state, jres.state)
    assert mesh.collectives == 1          # one gather for the whole wave
    for k in ("merge_collective_count", "state_bytes_shipped",
              "entries_scanned", "entries_kept"):
        assert res.report.counters[k] == jres.report.counters[k], k
    flat = T.unshard_mask_batch(res.keep, M)
    for i, q in enumerate(BATCHES[algo]):
        one = T.engine_prune(algo, torch.from_numpy(x), mode="mesh",
                             shards=S, mesh=_cpu8(), pass2="mesh", **q)
        assert torch.equal(flat[i], T.unshard_mask(one.keep, M))


@pytest.mark.parametrize("algo", list(BATCHES))
def test_batch_master_wave_and_admission_waves(algo):
    """pass2="master" gives the two_pass batch's flat keep; a budget of one
    query's state splits the resident batch into a wave a query, one gather
    each."""
    x = torch.from_numpy(_batch_stream(algo))
    qs = BATCHES[algo]
    two = T.engine_prune_batch(algo, qs, x, mode="two_pass", shards=S,
                               obs="off")
    res = T.engine_prune_batch(algo, qs, x, mode="mesh", shards=S,
                               mesh=_cpu8(), pass2="master")
    assert torch.equal(res.keep, two.keep)
    _state_eq(res.state, two.state)
    whole = T.engine_prune_batch(algo, qs, x, mode="mesh", shards=S,
                                 mesh=_cpu8())
    budget = whole.report.counters["state_bytes_shipped"] // (
        POSITIONS * len(qs))
    mesh = _cpu8()
    waved = T.engine_prune_batch(algo, qs, x, mode="mesh", shards=S,
                                 mesh=mesh, device_budget_bytes=budget)
    waves = len(waved.plan.waves)
    assert waves == len(qs) and mesh.collectives == waves
    assert waved.report.counters["merge_collective_count"] == waves
    assert torch.equal(T.unshard_mask_batch(waved.keep, M), two.keep)


# ----------------------------------------------------------------- stream
STREAM_SIZES = (700, 512, 789)


def test_mesh_stream_matches_the_reference():
    rng = np.random.default_rng(12)
    x = rng.integers(1, 300, sum(STREAM_SIZES)).astype(np.uint32)
    kw = dict(shards=S, merge_every=2, d=32, w=4, policy="fifo")
    j = JS.PruneStream("distinct", mesh=_jmesh(), obs="off", **kw)
    mesh = _cpu8()
    t = TS.PruneStream("distinct", mesh=mesh, obs="counters", **kw)
    lo = 0
    for b in STREAM_SIZES:
        j.fold(jnp.asarray(x[lo:lo + b]))
        t.fold(torch.from_numpy(x[lo:lo + b]))
        lo += b
    jres, res = j.close(), t.close()
    _eq(res.keep, jres.keep)
    _eq(res.live_keep, jres.live_keep)
    _state_eq(res.state, jres.state)
    assert res.stats["merges"] == jres.stats["merges"] == mesh.collectives
    per_merge = res.report.counters["state_bytes_shipped"] // mesh.collectives
    assert per_merge == S * (32 * 4 * 5 + 32 * 4) * POSITIONS
    one = TS.PruneStream("distinct", obs="off", **kw)
    lo = 0
    for b in STREAM_SIZES:
        one.fold(torch.from_numpy(x[lo:lo + b]))
        lo += b
    assert torch.equal(one.close().keep, res.keep)
    default = TS.PruneStream("distinct", mesh=_cpu8(), d=8, w=2)
    assert default.shards == POSITIONS


# ------------------------------------------------------------ query layer
@functools.lru_cache(maxsize=None)
def _tables():
    jtab = jt.make_uservisits(ROWS, seed=4)
    jrank = jt.make_rankings(ROWS // 4, seed=5)
    ttab = tt.make_uservisits(ROWS, seed=4, device="cpu")
    trank = tt.make_rankings(ROWS // 4, seed=5, device="cpu")
    return jtab, jrank, ttab, trank


QUERIES = [
    ("topn", ("ad_revenue",), dict(d=64, w=4, N=10)),
    ("topn", ("ad_revenue",), dict(mode="det", N=10, w=4)),
    ("distinct", ("source_ip",), dict(d=64, w=4, policy="fifo")),
    ("skyline", ("ad_revenue", "duration"), dict(w=4)),
    ("having", ("source_ip", "duration"),
     dict(threshold=10, agg="count", width=256)),
    ("groupby", ("source_ip", "duration"), dict(d=64, w=4, agg="count")),
    ("join", ("dest_url", "page_url"), dict(nbits=1 << 12)),
    ("filter", ("duration",), dict(formula=None)),
]
# the reference's mesh runs held here: GROUP BY's emissions and JOIN's
# OR-merge (every other kind against the port without a mesh, which
# test_torch_query.py holds to the reference; DISTINCT's lane ranks are
# held in test_run_queries_with_a_mesh and test_torch_mesh.py)
WITH_REFERENCE = ("groupby", "join")


def _same_answer(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same_answer, a, b))
    return a == b


def _np_answer(x):
    if isinstance(x, (tuple, list)):
        return [_np_answer(y) for y in x]
    if isinstance(x, dict):
        return {int(k): float(v) for k, v in x.items()}
    return np.asarray(x).tolist()


def _tables_for(kind, which):
    jtab, jrank, ttab, trank = _tables()
    if which == "jax":
        return (jtab, jrank) if kind == "join" else jtab
    return (ttab, trank) if kind == "join" else ttab


def _spec(mod, kind, cols, params):
    if kind == "filter":
        from repro_torch.core import filter as tf
        params = dict(formula=tf.Pred("duration", "gt", 30))
    return mod.QuerySpec(kind, cols, params)


@pytest.mark.parametrize("kind,cols,params", QUERIES,
                         ids=[q[0] + str(i) for i, q in enumerate(QUERIES)])
def test_run_query_with_a_mesh(kind, cols, params):
    mesh = _cpu8("data")
    tspec = _spec(tq, kind, cols, params)
    got = tq.run_query(tspec, _tables_for(kind, "torch"), mesh=mesh)
    plain = tq.run_query(tspec, _tables_for(kind, "torch"))
    assert _same_answer(got["output"], plain["output"])
    if kind in WITH_REFERENCE:
        jspec = jq.QuerySpec(kind, cols, params)
        want = jq.run_query(jspec, _tables_for(kind, "jax"),
                            mesh=_jmesh("data"), axis="data")
        _eq(got["keep"], want["keep"])
        if kind == "join":  # the port's three aligned columns, as triples
            assert list(zip(*(t.tolist() for t in got["output"]))) == \
                [tuple(r) for r in want["output"]]
        else:
            assert _np_answer(got["output"]) == _np_answer(want["output"])


def test_run_queries_with_a_mesh():
    """A DISTINCT group (one resident wave, one gather), a JOIN and a
    singleton, against the reference's run_queries on its mesh."""
    jtab, jrank, ttab, trank = _tables()
    specs = [("distinct", ("source_ip",), dict(d=64, w=4)),
             ("distinct", ("source_ip",), dict(d=32, w=2, seed=3)),
             ("topn", ("ad_revenue",), dict(mode="det", N=10, w=4))]
    mesh = _cpu8("data")
    got = tq.run_queries([tq.QuerySpec(*s) for s in specs], ttab, mesh=mesh)
    want = jq.run_queries([jq.QuerySpec(*s) for s in specs], jtab,
                          mesh=_jmesh("data"), axis="data")
    for g, w in zip(got, want):
        _eq(g["keep"], w["keep"])
        assert _np_answer(g["output"]) == _np_answer(w["output"])
    # the group's wave, then the singleton's call: one gather each
    assert mesh.collectives == 2
    assert got[0]["report"] is got[1]["report"]
    with pytest.raises(ValueError, match="worker mesh"):
        tq.run_queries([tq.QuerySpec(*specs[0])], ttab, mesh=mesh,
                       tune="race")
    with pytest.raises(ValueError, match="worker mesh"):
        jq.run_queries([jq.QuerySpec(*specs[0])], jtab, mesh=_jmesh("data"),
                       tune="race")


# ---------------------------------------------------------------- planner
@pytest.mark.parametrize("S_fixed", [2, 8, 13])
@pytest.mark.parametrize("name", ["topn_det", "distinct", "skyline"])
def test_mesh_plans_match(name, S_fixed, monkeypatch):
    """At max_devices=8 the incumbent spreads over the largest divisor of S
    and the grid adds the two widest spreads x (mesh, master), as the
    reference's."""
    js, ts, p = _bed(name)
    _fix_lanes(monkeypatch, S_fixed)
    for md in (8, 4):
        want = jplanner.analytic_plan(name, js, p, max_devices=md)
        got = tplanner.analytic_plan(name, ts, p, max_devices=md)
        assert got.key() == want.key()
        assert _keys(tplanner.candidate_plans(name, ts, p, max_devices=md)) \
            == _keys(jplanner.candidate_plans(name, js, p, max_devices=md))
    assert tplanner.analytic_plan(name, ts, p).mode == "two_pass"


@pytest.mark.parametrize("name", ["topn_det", "distinct", "having"])
def test_mesh_plans_execute_flat(name, monkeypatch):
    js, ts, p = _bed(name)
    _fix_lanes(monkeypatch, 8)
    plans = tplanner.candidate_plans(name, ts, p, max_devices=8)
    assert any(q.mode == "mesh" for q in plans)
    base = tengine.execute_plan(name, *ts, plan=tplanner.Plan(
        mode="two_pass", shards=8), **p).keep
    for plan in plans:
        keep = tengine.execute_plan(name, *ts, plan=plan, **p).keep
        assert keep.shape == (ts[0].shape[0],) and torch.equal(keep, base)
    want = jengine.execute_plan(name, *js, plan=jplanner.Plan.from_dict(
        plans[0].to_dict()), **p)
    _eq(base, want.keep)
    qs = [p, dict(p)]
    mesh_plan = tplanner.Plan(mode="mesh", shards=8, pass2="mesh",
                              num_devices=4)
    rb = T.execute_plan_batch(name, qs, *ts, plan=mesh_plan)
    assert rb.keep.shape == (2, ts[0].shape[0])
    assert torch.equal(rb.keep[0], base) and torch.equal(rb.keep[1], base)
