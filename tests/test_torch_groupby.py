"""The port's GROUP BY pruning against the JAX package's, on the CPU.

Same numpy-seeded keys and values through both packages. Keep masks,
emissions (evicted key, aggregate and valid flag at every entry) and final
caches are bit-identical: the switch's folds are f32 adds, compares and
``+ 1.0`` in entry order on both sides. The master's f64 fold is exact for
integer-valued values; for non-integer values its order of adds differs
(a segment sum here, emission order in the JAX package), so those answers
are held to 1e-12 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core import groupby as jgroupby
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import convert
from repro_torch import core as T
from repro_torch.kernels import groupby_scan as G
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt

AGGS = ("sum", "count", "min", "max")
MODES = ("scan", "sharded", "two_pass")


def _data(m, seed=0, universe=200, integer=False):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, m) % universe).astype(np.uint32)
    keys[::53] = np.uint32(0xFFFFFFFF)
    vals = (rng.integers(-20, 50, m).astype(np.int32) if integer
            else rng.normal(size=m).astype(np.float32) * 10)
    valid = rng.random(m) < 0.8
    return keys, vals, valid


def _eq(t, j):
    t = t.view(torch.int32) if t.dtype == torch.uint32 else t
    j = np.asarray(j)
    j = j.view(np.int32) if j.dtype == np.uint32 else j
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), j)


def _same_result(tr, jr):
    _eq(tr.keep, jr.keep)
    for a, b in zip(tr.emitted, jr.emitted):
        _eq(a, b)
    for f in ("keys", "aggs", "valid"):
        _eq(getattr(tr.state, f), getattr(jr.state, f))


def _close(got: dict, want: dict, rel=0.0):
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= rel * abs(v), (k, got[k], v)


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("with_valid", [False, True])
def test_groupby_prune_matches(agg, with_valid):
    keys, vals, valid = _data(3001, seed=AGGS.index(agg))
    v = valid if with_valid else None
    jr = J.groupby_prune(jnp.asarray(keys), jnp.asarray(vals),
                         None if v is None else jnp.asarray(v), d=8, w=3,
                         agg=agg, seed=2)
    tr = T.groupby_prune(torch.from_numpy(keys), torch.from_numpy(vals),
                         None if v is None else torch.from_numpy(v), d=8, w=3,
                         agg=agg, seed=2)
    _same_result(tr, jr)
    assert not bool(tr.keep.any())
    # non-integer f32 partials: the f64 fold's order moves the last bits
    _close(T.master_complete_groupby(tr, agg),
           J.master_complete_groupby(jr, agg), rel=1e-12)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_pass1_lanes_are_independent_scans(shards):
    """groupby_pass1 over S lanes: each lane equals the JAX scan of its
    shard, emissions and cache alike (d above and below 2^16 rows)."""
    keys, vals, _ = _data(24 * shards, seed=shards, universe=40)
    for d in (5, 1 << 16):
        (ek, ea, ev), (sk, sa, sv) = G.groupby_pass1_kernel(
            torch.from_numpy(keys), torch.from_numpy(vals), d=d, w=2,
            agg="sum", seed=4, shards=shards)
        n = keys.shape[0] // shards
        for s in range(shards):
            cut = slice(s * n, (s + 1) * n)
            jr = J.groupby_prune(jnp.asarray(keys[cut]),
                                 jnp.asarray(vals[cut]), d=d, w=2,
                                 agg="sum", seed=4)
            for a, b in zip((ek[cut], ea[cut], ev[cut]), jr.emitted):
                _eq(a, b)
            for a, f in zip((sk[s], sa[s], sv[s]), ("keys", "aggs", "valid")):
                _eq(a, getattr(jr.state, f))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shards", [1, 2, 8])
@pytest.mark.parametrize("agg", AGGS)
def test_engine_groupby_bit_identical(mode, shards, agg):
    """Ragged m: the parallel modes append a validity column and pad, and
    the emissions keep the full padded length."""
    keys, vals, _ = _data(997, seed=shards, universe=60, integer=True)
    jr = J.engine_prune("groupby", jnp.asarray(keys), jnp.asarray(vals),
                        mode=mode, shards=shards, d=8, w=2, agg=agg)
    tr = T.engine_prune("groupby", torch.from_numpy(keys),
                        torch.from_numpy(vals), mode=mode, shards=shards,
                        d=8, w=2, agg=agg)
    _same_result(tr, jr)
    got = T.master_complete_groupby(tr, agg)
    assert got == J.master_complete_groupby(jr, agg)
    assert got == J.groupby_oracle(jnp.asarray(keys), jnp.asarray(vals), agg)


@pytest.mark.parametrize("mode", MODES)
def test_engine_groupby_with_a_validity_column(mode):
    keys, vals, valid = _data(1001, seed=9, integer=True)
    args_j = [jnp.asarray(x) for x in (keys, vals, valid)]
    args_t = [torch.from_numpy(x) for x in (keys, vals, valid)]
    jr = J.engine_prune("groupby", *args_j, mode=mode, shards=4, d=16, w=4,
                        agg="count")
    tr = T.engine_prune("groupby", *args_t, mode=mode, shards=4, d=16, w=4,
                        agg="count")
    _same_result(tr, jr)
    assert T.master_complete_groupby(tr, "count") == \
        J.master_complete_groupby(jr, "count")


@pytest.mark.parametrize("mode", MODES)
def test_groupby_pad_eviction_reaches_master(mode):
    """A tail pad can evict a real partial; its emission sits past m."""
    keys = np.arange(7, dtype=np.uint32)
    vals = (np.arange(7, dtype=np.int32) + 1) * 10
    r = T.engine_prune("groupby", torch.from_numpy(keys),
                       torch.from_numpy(vals), mode=mode, shards=2, d=1, w=2,
                       agg="sum")
    assert r.emitted[0].shape[0] == (7 if mode == "scan" else 8)
    assert T.master_complete_groupby(r, "sum") == \
        J.groupby_oracle(jnp.asarray(keys), jnp.asarray(vals), "sum")


@pytest.mark.parametrize("agg", AGGS)
def test_master_complete_and_oracle_match(agg):
    keys, vals, _ = _data(2000, seed=11, integer=True)
    jr = J.groupby_prune(jnp.asarray(keys), jnp.asarray(vals), d=4, w=2,
                         agg=agg)
    state = convert.groupby_state_from_numpy(
        np.asarray(jr.state.keys), np.asarray(jr.state.aggs),
        np.asarray(jr.state.valid), device="cpu")
    emitted = tuple(torch.from_numpy(np.array(e)) for e in jr.emitted)
    got = T.master_complete_groupby(T.PruneResult(None, state, emitted), agg)
    assert got == J.master_complete_groupby(jr, agg)
    assert T.groupby_oracle(torch.from_numpy(keys), torch.from_numpy(vals),
                            agg) == J.groupby_oracle(keys, vals, agg)


def test_oracle_non_integer_sums_within_tolerance():
    keys, vals, _ = _data(3000, seed=12)
    _close(T.groupby_oracle(torch.from_numpy(keys), torch.from_numpy(vals)),
           J.groupby_oracle(keys, vals), rel=1e-12)


def _run_both(agg, m=1500, d=16, w=2):
    ua = jt.make_uservisits(m, seed=3)
    tua = tt.make_uservisits(m, seed=3, device="cpu")
    spec = dict(d=d, w=w, agg=agg)
    a = jq.run_query(jq.QuerySpec("groupby", ("source_ip", "ad_revenue"),
                                  spec), ua, obs="off")
    b = tq.run_query(tq.QuerySpec("groupby", ("source_ip", "ad_revenue"),
                                  spec), tua)
    _eq(b["keep"], a["keep"])
    assert (b["forwarded"], b["total"]) == (a["forwarded"], a["total"])
    return a, b


@pytest.mark.parametrize("agg", AGGS)
def test_run_query_groupby_matches(agg):
    """The Big Data benchmark's Query 2 shape: aggregate ad_revenue by
    source_ip. COUNT, MIN and MAX are exact; SUM of non-integer revenue
    is held to 1e-12 relative (order of the f64 fold)."""
    a, b = _run_both(agg)
    _close(b["output"], a["output"], rel=1e-12 if agg == "sum" else 0.0)


def test_groupby_traffic_inverted_matches_reference():
    """100 rows of key 7, value 1.0, d=4, w=2: one partial (the state slot)
    reaches the master, yet the reference reports keep = ~traffic, so
    forwarded counts the 107 slots that sent nothing (ROADMAP Queue 3). The
    port reproduces it."""
    cols = {"k": np.full(100, 7, np.uint32), "v": np.ones(100, np.float32)}
    spec = dict(d=4, w=2)
    a = jq.run_query(jq.QuerySpec("groupby", ("k", "v"), spec),
                     jt.Table("t", {c: jnp.asarray(x) for c, x in
                                    cols.items()}), obs="off")
    b = tq.run_query(tq.QuerySpec("groupby", ("k", "v"), spec),
                     convert.table_from_numpy(cols, device="cpu"))
    assert a["output"] == b["output"] == {7: 100.0}
    _eq(b["keep"], a["keep"])
    assert (a["forwarded"], a["total"]) == (b["forwarded"], b["total"]) \
        == (107, 108)
    assert int((~b["keep"]).sum()) == 1  # the true switch->master traffic


def test_groupby_state_resume_raises():
    """A resumed scan (the carried cache of a first call) emits and ends as
    the reference's resumed scan, bit for bit; the carried state stays."""
    rng = np.random.default_rng(7)
    k = rng.integers(0, 40, 300).astype(np.uint32)
    v = rng.integers(1, 9, 300).astype(np.float32)
    a = T.groupby_prune(torch.from_numpy(k[:120]), torch.from_numpy(v[:120]),
                        d=4, w=2)
    ja = jgroupby.groupby_prune(jnp.asarray(k[:120]), jnp.asarray(v[:120]),
                                d=4, w=2)
    kept = a.state.aggs.clone()
    b = T.groupby_prune(torch.from_numpy(k[120:]), torch.from_numpy(v[120:]),
                        d=4, w=2, state=a.state)
    jb = jgroupby.groupby_prune(jnp.asarray(k[120:]), jnp.asarray(v[120:]),
                                d=4, w=2, state=ja.state)
    for t, j in zip(b.emitted, jb.emitted):
        _eq(t, j)
    for f in ("keys", "aggs", "valid"):
        _eq(getattr(b.state, f), getattr(jb.state, f))
    assert torch.equal(a.state.aggs, kept)


@pytest.mark.parametrize("agg", AGGS)
def test_groupby_init_matches(agg):
    js = jgroupby.groupby_init(4, 3, agg)
    ts = T.groupby_init(4, 3, agg, device="cpu")
    for f in ("keys", "aggs", "valid"):
        _eq(getattr(ts, f), getattr(js, f))
