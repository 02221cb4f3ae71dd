"""Multi-query batching: the port's ``engine_prune_batch`` and
``run_queries`` against the JAX package's, bit for bit.

The same numpy-seeded streams go through both packages on the CPU. The
port's batch is held to the reference's *batched* output (keep, state and
emitted, pads included), and each query's batch keep to the port's own
serial ``engine_prune``. The batched walks' plain versions are held to the
serial plain pass 1, query by query, padded to the batch's caps.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core.encoding import dict_encode as j_dict_encode
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import core as T
from repro_torch.constants import NEG
from repro_torch.core.encoding import dict_encode as t_dict_encode
from repro_torch.kernels import batch_walks as BW
from repro_torch.kernels import parallel as tpar
from repro_torch.kernels.groupby_scan import groupby_pass1_plain
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_engine_batch import _CASES  # noqa: E402

_IDS = [c[0] for c in _CASES]
FLT_MIN = np.float32(np.finfo(np.float32).tiny)


def _streams(mk, seed):
    """The case's streams as numpy arrays (the reference's maker)."""
    return tuple(np.asarray(s) for s in mk(np.random.default_rng(seed)))


@functools.lru_cache(maxsize=None)
def _port_batch(algo, mode, seed):
    """The port's batch of one case (cached beside the reference's)."""
    xs, queries, kw, _ = _jax_batch(algo, mode, seed)
    ts = tuple(map(torch.from_numpy, xs))
    return ts, T.engine_prune_batch(algo, queries, *ts, obs="off", **kw)


@functools.lru_cache(maxsize=None)
def _jax_batch(algo, mode, seed):
    """The reference's batch of one case, computed once a module."""
    mk, queries = next((mk, q) for a, mk, q in _CASES if a == algo)
    kw = dict(mode="scan") if mode == "scan" else dict(mode=mode, shards=8)
    xs = _streams(mk, seed)
    return xs, queries, kw, J.engine_prune_batch(
        algo, queries, *map(jnp.asarray, xs), obs="off", **kw)


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a
    return a.view(f"u{a.dtype.itemsize}")


def _same(t, j):
    got, want = t.numpy(), np.asarray(j)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _same_state(t, j):
    """A state of the port against the reference's: every field by name
    (DistinctMerged's owner shards through its property), or one tensor."""
    if isinstance(t, torch.Tensor):
        return _same(t, j)
    for f in dataclasses.fields(j):
        _same(getattr(t, f.name), getattr(j, f.name))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["scan", "two_pass"])
@pytest.mark.parametrize("algo", _IDS)
def test_batch_matches_reference(algo, mode, seed):
    """The reference's six mixed batches (m = 2001, so that the two_pass
    lanes carry tail pads): keep, state and emitted by their bits."""
    _, queries, kw, jr = _jax_batch(algo, mode, seed)
    tr = _port_batch(algo, mode, seed)[1]
    _same(tr.keep, jr.keep)
    _same_state(tr.state, jr.state)
    if jr.emitted is None:
        assert tr.emitted is None
    else:
        for a, b in zip(tr.emitted, jr.emitted):
            _same(a, b)
    assert tr.plan.waves == jr.plan.waves
    assert tr.plan.per_query_bytes == jr.plan.per_query_bytes


@pytest.mark.parametrize("mode", ["scan", "two_pass"])
@pytest.mark.parametrize("algo", _IDS)
def test_batch_keep_equals_serial_engine(algo, mode):
    """Each query's batch keep is the port's serial ``engine_prune``."""
    _, queries, kw, _ = _jax_batch(algo, mode, 0)
    ts, tr = _port_batch(algo, mode, 0)
    for i, q in enumerate(queries):
        s = T.engine_prune(algo, *ts, obs="off", **kw, **q)
        assert torch.equal(tr.keep[i], s.keep), (algo, q)


@pytest.mark.parametrize("decode", ["auto", "eager"])
def test_batch_on_dictionary_codes(decode):
    """The DISTINCT case's stream dictionary-encoded through
    ``encoding=``, pruned on codes (auto) or decoded first (eager), in
    two_pass (the pads are the dictionary's pad slot)."""
    xs, queries, kw, _ = _jax_batch("distinct", "two_pass", 0)
    jc, je = j_dict_encode(jnp.asarray(xs[0]))
    tc, te = t_dict_encode(torch.from_numpy(xs[0]))
    jr = J.engine_prune_batch("distinct", queries, jc, encoding=je,
                              decode=decode, obs="off", **kw)
    tr = T.engine_prune_batch("distinct", queries, tc, encoding=te,
                              decode=decode, obs="off", **kw)
    _same(tr.keep, jr.keep)
    _same_state(tr.state, jr.state)


def test_batch_budget_splits_into_waves():
    """A budget of two queries' charges splits DISTINCT (two_pass) into
    waves, as the reference plans them; the waves' results concatenate in
    query order to the one-wave batch's, and the report counts as the
    reference's (a span a wave; one merge collective and the wave's state
    bytes a wave; every query's entries)."""
    xs, queries, kw, free = _jax_batch("distinct", "two_pass", 0)
    budget = 2 * free.plan.per_query_bytes[0]
    jr = J.engine_prune_batch("distinct", queries, *map(jnp.asarray, xs),
                              device_budget_bytes=budget, obs="counters",
                              **kw)
    tr = T.engine_prune_batch("distinct", queries, *map(torch.from_numpy, xs),
                              device_budget_bytes=budget, obs="counters",
                              **kw)
    assert tr.plan.waves == jr.plan.waves == ((0, 1), (2,))
    _same(tr.keep, free.keep)
    _same_state(tr.state, free.state)
    assert tr.report.counters == jr.report.counters
    assert tr.report.meta == jr.report.meta


def test_batch_having_threshold_typing_and_plus_zero_rows():
    """A float threshold in the batch compares every query in f32 (an
    int32 table's estimates converted); the batched build reads a sum of
    -0 as +0 in every row (ROADMAP Queue 3 Part B: the serial jitted body
    keeps -0 in rows 0 and 1)."""
    xs, queries, kw, _ = _jax_batch("having", "two_pass", 0)
    queries = [dict(q, threshold=t) for q, t in zip(queries,
                                                    (500, 900.5, 50))]
    jr = J.engine_prune_batch("having", queries, *map(jnp.asarray, xs),
                              obs="off", **kw)
    tr = T.engine_prune_batch("having", queries, *map(torch.from_numpy, xs),
                              obs="off", **kw)
    _same(tr.keep, jr.keep)
    _same(tr.state, jr.state)
    k = np.repeat(np.arange(32, dtype=np.uint32), 2)
    w = (np.tile(np.array([-1.5, 1.0], np.float32), 32) * FLT_MIN).astype(
        np.float32)
    queries = [dict(threshold=0.0, rows=5, width=64),
               dict(threshold=0.0, rows=3, width=32, seed=3)]
    jr = J.engine_prune_batch("having", queries, jnp.asarray(k),
                              jnp.asarray(w), mode="scan", obs="off")
    tr = T.engine_prune_batch("having", queries, torch.from_numpy(k),
                              torch.from_numpy(w), mode="scan", obs="off")
    _same(tr.state, jr.state)
    assert not np.signbit(np.asarray(jr.state)).any()
    serial = J.engine_prune("having", jnp.asarray(k), jnp.asarray(w),
                            mode="scan", obs="off", **queries[0])
    assert np.signbit(np.asarray(serial.state.table)[:2]).any()


def test_batch_streams_of_other_dtypes():
    """DISTINCT over int32 and float32 streams (the slots compared with the
    stream's own dtype) and GROUP BY over f32 values with NaN and -0."""
    rng = np.random.default_rng(9)
    qd = [dict(d=8, w=2, policy="fifo"), dict(d=16, w=3, seed=3,
                                              policy="fifo")]
    x = rng.integers(-50, 50, 401).astype(np.int32)
    f = (x + np.float32(0.5) * (rng.random(401) < 0.3)).astype(np.float32)
    vals = rng.standard_normal(401).astype(np.float32)
    vals[::37] = np.nan
    vals[5::41] = -0.0
    keys = rng.integers(0, 30, 401).astype(np.uint32)
    cases = [("distinct", (x,), qd, dict(mode="scan")),
             ("distinct", (f,), qd, dict(mode="two_pass", shards=5)),
             ("groupby", (keys, vals),
              [dict(d=8, w=2, agg="min"), dict(d=4, w=3, agg="min", seed=1)],
              dict(mode="two_pass", shards=5))]
    for algo, xs, queries, kw in cases:
        jr = J.engine_prune_batch(algo, queries, *map(jnp.asarray, xs),
                                  obs="off", **kw)
        tr = T.engine_prune_batch(algo, queries, *map(torch.from_numpy, xs),
                                  obs="off", **kw)
        _same(tr.keep, jr.keep)
        _same_state(tr.state, jr.state)
        if jr.emitted is not None:
            for a, b in zip(tr.emitted, jr.emitted):
                _same(a, b)


def test_batch_refusals():
    """The reference's errors, the mesh's among them."""
    v = torch.ones(64, dtype=torch.uint32)
    f = torch.ones(64, dtype=torch.float32)
    with pytest.raises(ValueError, match="policy"):
        T.engine_prune_batch("distinct", [dict(d=8, w=2, policy="lru"),
                                          dict(d=8, w=2, policy="fifo")],
                             v, mode="scan")
    with pytest.raises(ValueError, match="2\\^16"):
        T.engine_prune_batch("distinct", [dict(d=8, w=2),
                                          dict(d=1 << 17, w=2)],
                             v, mode="scan")
    with pytest.raises(ValueError, match="agg"):
        T.engine_prune_batch("groupby", [dict(d=8, w=2, agg="sum"),
                                         dict(d=8, w=2, agg="max")],
                             v, v, mode="scan")
    with pytest.raises(ValueError, match="concrete"):
        T.engine_prune_batch("topn_det", [dict(N=2, w=4)], f,
                             mode="two_pass", shards="auto")
    with pytest.raises(ValueError, match="mode"):
        T.engine_prune_batch("topn_det", [dict(N=2, w=4)], f,
                             mode="sharded")
    with pytest.raises(ValueError, match="mesh"):
        T.engine_prune_batch("topn_det", [dict(N=2, w=4)], f,
                             mode="two_pass", shards=4, pass2="mesh")
    with pytest.raises(ValueError, match="at least one"):
        T.engine_prune_batch("topn_det", [], f, mode="scan")
    with pytest.raises(ValueError, match="tune"):
        T.engine_prune_batch("topn_det", [dict(N=2, w=4)], f,
                             options=T.ExecOptions(tune="race"))
    with pytest.raises(ValueError, match="pass2 must be one of"):
        T.engine_prune_batch("topn_det", [dict(N=2, w=4)], f, mode="mesh",
                             pass2="sideways")
    with pytest.raises(ValueError, match="divisible"):
        T.engine_prune_batch("topn_det", [dict(N=2, w=4)], f, mode="mesh",
                             shards=3, mesh=T.Mesh(("cpu",) * 2))


# --------------------------------------------------- the batched walks
def _wave(seed=0):
    rng = np.random.default_rng(seed)
    return ([64, 128, 32, 64], [3, 6, 2, 4], [1, 2, 0, 9],
            rng.integers(0, 400, 1200))


def test_topn_pass1_batch_plain_is_the_serial_loop():
    d, w, seeds, x = _wave()
    v = torch.from_numpy(x.astype(np.float32))
    keep, st = BW.topn_pass1_batch(v, d=d, w=w, seeds=seeds, shards=3,
                                   dcap=128, wcap=6)
    for q in range(4):
        k, s = tpar.topn_shard_states_kernel(v, d=d[q], w=w[q], shards=3,
                                             block=1, seed=seeds[q],
                                             family="engine")
        assert torch.equal(keep[q], k)
        assert torch.equal(st[q, :, :d[q], :w[q]], s)
        assert bool((st[q, :, d[q]:] == NEG).all())
        assert bool((st[q, :, :, w[q]:] == NEG).all())


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_distinct_pass1_batch_plain_is_the_serial_loop(policy):
    d, w, seeds, x = _wave(1)
    v = torch.from_numpy(x.astype(np.uint32))
    keep, slots, valid, head = BW.distinct_pass1_batch(
        v, d=d, w=w, seeds=seeds, shards=4, dcap=128, wcap=6, policy=policy)
    for q in range(4):
        k, s, vl, h = tpar.distinct_shard_states_kernel(
            v, d=d[q], w=w[q], shards=4, block=1, seed=seeds[q],
            policy=policy)
        assert torch.equal(keep[q], k)
        assert torch.equal(slots[q, :, :d[q], :w[q]], s)
        assert torch.equal(valid[q, :, :d[q], :w[q]], vl)
        assert torch.equal(head[q, :, :d[q]], h)
        assert not bool(valid[q, :, :, w[q]:].any())
        assert not bool(valid[q, :, d[q]:].any())


def test_groupby_pass1_batch_plain_is_the_serial_loop():
    d, w, seeds, x = _wave(2)
    keys = torch.from_numpy((x % 50).astype(np.uint32))
    vals = torch.from_numpy(x.astype(np.float32) / 7)
    ev, st = BW.groupby_pass1_batch(keys, vals, None, d=d, w=w, seeds=seeds,
                                    agg="sum", shards=2, dcap=128, wcap=6)
    for q in range(4):
        e, s = groupby_pass1_plain(keys.reshape(2, -1), vals.reshape(2, -1),
                                   None, d=d[q], w=w[q], agg="sum",
                                   seed=seeds[q])
        for a, b in zip(ev, e):
            assert torch.equal(a[q], b.reshape(-1))
        for a, b in zip(st, s):
            assert torch.equal(a[q, :, :d[q], :w[q]], b)
        assert not bool(st[2][q, :, :, w[q]:].any())


def test_batch_wide_rows_take_the_serial_kernels():
    """A batch whose cap is wider than the batched walks' 32 slots runs the
    serial pass 1 query by query, into the same padded state."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 2000, 1500).astype(np.uint32)
    queries = [dict(d=8, w=40), dict(d=4, w=3, seed=2)]
    jr = J.engine_prune_batch("distinct", queries, jnp.asarray(x),
                              mode="scan", obs="off")
    tr = T.engine_prune_batch("distinct", queries, torch.from_numpy(x),
                              mode="scan", obs="off")
    _same(tr.keep, jr.keep)
    _same_state(tr.state, jr.state)


# ------------------------------------------------------------ run_queries
def _specs():
    S = jq.QuerySpec
    return [
        S("topn", ("ad_revenue",), dict(mode="det", N=40, w=4)),
        S("distinct", ("source_ip",), dict(d=128, w=4)),
        S("topn", ("ad_revenue",), dict(mode="det", N=10, w=6)),
        S("distinct", ("source_ip",), dict(d=64, w=2)),
        S("topn", ("ad_revenue",), dict(d=256, w=8, N=25, seed=3)),
        S("topn", ("ad_revenue",), dict(d=128, w=4, N=25)),
        S("distinct", ("source_ip",), dict(d=64, w=3, policy="fifo")),
        S("distinct", ("source_ip",), dict(d=32, w=2, policy="fifo",
                                           seed=4)),
        S("groupby", ("lang", "ad_revenue"), dict(d=16, w=2)),
        S("groupby", ("lang", "ad_revenue"), dict(d=8, w=4, seed=1)),
        S("having", ("lang", "ad_revenue"),
          dict(threshold=20000.0, rows=2, width=256)),
        S("having", ("lang", "ad_revenue"),
          dict(threshold=5000.0, rows=3, width=512)),
        S("skyline", ("ad_revenue", "duration"), dict(w=4)),
        S("skyline", ("ad_revenue", "duration"), dict(w=6)),
        S("skyline", ("ad_revenue", "duration"), dict(w=5, score="sum")),
        S("filter", ("duration",), dict(formula=None)),
    ]


def _same_result(t, j):
    assert t["forwarded"] == j["forwarded"] and t["total"] == j["total"]
    np.testing.assert_array_equal(t["keep"].numpy(), np.asarray(j["keep"]))
    x, y = t["output"], j["output"]
    if isinstance(y, tuple):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(y, dict):
        assert set(x) == set(y)
        for k in y:
            assert x[k] == pytest.approx(y[k], rel=1e-12, abs=0), k
    elif isinstance(y, list):
        assert list(x) == list(y)
    else:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _both_run_queries(specs, tspecs, jtab, ttab):
    jres = jq.run_queries(specs, jtab, obs="off")
    tres = tq.run_queries(tspecs, ttab, obs="off")
    assert len(tres) == len(specs)
    for t, j in zip(tres, jres):
        _same_result(t, j)


def test_run_queries_matches_reference():
    """A mixed spec list on a 2^12-row uservisits table: two or more specs
    of each family, a FILTER and a singleton (the SUM-score SKYLINE), and a
    JOIN with a rankings table; outputs, keep masks and ``forwarded`` in
    input order."""
    from repro.core.filter import Pred
    from repro_torch.core.filter import Pred as TPred

    jtab = jt.make_uservisits(1 << 12, seed=5)
    ttab = tt.make_uservisits(1 << 12, seed=5, device="cpu")
    specs = _specs()
    specs[-1] = jq.QuerySpec("filter", ("duration",),
                             dict(formula=Pred("duration", "gt", 100)))
    tspecs = [tq.QuerySpec(s.kind, s.columns, dict(s.params)) for s in specs]
    tspecs[-1] = tq.QuerySpec("filter", ("duration",),
                              dict(formula=TPred("duration", "gt", 100)))
    _both_run_queries(specs, tspecs, jtab, ttab)
    jrk = jt.make_rankings(1 << 10, seed=6)
    trk = tt.make_rankings(1 << 10, seed=6, device="cpu")
    join = ("join", ("dest_url", "page_url"), dict(nbits=1 << 12))
    jj = jq.run_queries([jq.QuerySpec(*join)], (jtab, jrk), obs="off")[0]
    tj = tq.run_queries([tq.QuerySpec(*join)], (ttab, trk), obs="off")[0]
    assert tj["forwarded"] == jj["forwarded"]
    np.testing.assert_array_equal(tj["keep"].numpy(), np.asarray(jj["keep"]))
    # the port's JOIN output is the three aligned columns of the matches
    assert list(zip(*(c.tolist() for c in tj["output"]))) == jj["output"]


def test_run_queries_on_encoded_columns():
    """Dictionary (``source_ip``) and RLE (``lang``) columns: DISTINCT
    groups prune on codes, HAVING groups on the RLE column's codes."""
    jtab = jt.make_uservisits(1 << 11, seed=8).encode("source_ip").encode(
        "lang", rle=True)
    ttab = tt.make_uservisits(1 << 11, seed=8, device="cpu").encode(
        "source_ip").encode("lang", rle=True)
    specs = [s for s in _specs() if s.kind in ("distinct", "having")]
    tspecs = [tq.QuerySpec(s.kind, s.columns, dict(s.params)) for s in specs]
    _both_run_queries(specs, tspecs, jtab, ttab)


def test_run_queries_members_share_the_group_report():
    ttab = tt.make_uservisits(1 << 11, seed=2, device="cpu")
    specs = [tq.QuerySpec("distinct", ("source_ip",), dict(d=64, w=2)),
             tq.QuerySpec("distinct", ("source_ip",), dict(d=32, w=4))]
    res = tq.run_queries(specs, ttab, obs="counters")
    assert res[0]["report"] is res[1]["report"]
    assert res[0]["report"].counters["entries_scanned"] == 2 * (1 << 11)
    for spec, r in zip(specs, res):
        s = tq.run_query(spec, ttab, obs="off")
        assert torch.equal(r["keep"], s["keep"])


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=T.Mesh(("cpu",) * 2, axis="data"),
          options=T.ExecOptions(shards=2)), "shards"),
    (dict(tune="race", mesh=T.Mesh(("cpu",) * 2, axis="data")),
     "worker mesh")])
def test_run_queries_refusals(kw, item):
    # the mesh sets the lanes at this layer, and tune= with a mesh is
    # refused as the reference refuses it
    ttab = tt.make_uservisits(64, seed=2, device="cpu")
    with pytest.raises(ValueError, match=item):
        tq.run_queries([tq.QuerySpec("topn", ("ad_revenue",),
                                     dict(d=8, w=2, N=5))], ttab, **kw)


# ---------------------------------- the batched reference's departures
# ROADMAP Queue 3 Part B: where the reference's batched HAVING departs from
# its serial engine_prune, the port follows the batch; each on its
# smallest input, the serial answer shown beside it.
_B_CASES = {
    # B16: every row of the batched table reads a sum of -0 as +0
    "b16": ((np.array([7, 7], np.uint32),
             (np.array([-1.5, 1.0], np.float32) * FLT_MIN).astype(
                 np.float32)),
            [dict(threshold=0.0, rows=2, width=4),
             dict(threshold=0.0, rows=2, width=4, seed=1)]),
    # B17: a float threshold in the batch compares every query in f32
    "b17": ((np.array([7], np.uint32), np.array([16777217], np.int32)),
            [dict(threshold=16777216, rows=1, width=4),
             dict(threshold=0.5, rows=1, width=4)]),
    # B18: rows past the query's read as FLT_MAX, so +inf reads FLT_MAX
    "b18": ((np.array([7], np.uint32), np.array([np.inf], np.float32)),
            [dict(threshold=float(np.finfo(np.float32).max), rows=1,
                  width=4), dict(threshold=0.0, rows=2, width=4)]),
}


@pytest.mark.parametrize("name", sorted(_B_CASES))
def test_batched_having_departs_from_serial_as_the_reference(name):
    xs, queries = _B_CASES[name]
    jr = J.engine_prune_batch("having", queries, *map(jnp.asarray, xs),
                              mode="scan", obs="off")
    tr = T.engine_prune_batch("having", queries, *map(torch.from_numpy, xs),
                              mode="scan", obs="off")
    _same(tr.keep, jr.keep)
    _same(tr.state, jr.state)
    js = J.engine_prune("having", *map(jnp.asarray, xs), mode="scan",
                        obs="off", **queries[0])
    ts = T.engine_prune("having", *map(torch.from_numpy, xs), mode="scan",
                        obs="off", **queries[0])
    _same(ts.keep, js.keep)
    if name == "b16":
        assert np.signbit(np.asarray(js.state.table)).any()
        assert not np.signbit(tr.state.numpy()).any()
    else:
        assert bool(js.keep[0]) and not bool(tr.keep[0, 0])
