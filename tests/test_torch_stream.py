"""The port's streaming engine (``repro_torch.core.streaming``) against the
JAX package's (``repro.core.streaming``), on the CPU.

The same numpy micro-batches, on the reference test's ``SHARDS`` and
``SIZES`` (``tests/test_stream_engine.py``: divisible and ragged batches,
mid-stream and final), go through both ``PruneStream``s: ``keep``,
``live_keep``, the final merged ``state``, the GROUP BY ``emitted`` streams
and the batch/entry/merge ``stats`` must be bit-identical, for all six
algorithms at merge_every 1 and 3. Each JAX stream is run once a module
(``_jax_run``). The contract with the one-shot engine (``close()`` equals
two_pass on ``lane_view``) is held in the port alone too.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import streaming as JS
from repro.core.encoding import dict_encode as jdict_encode
from repro_torch import core as T
from repro_torch.core import streaming as TS

SHARDS = 8
SIZES = [512, 384, 250, 384, 518]
M = sum(SIZES)
PARAMS = {
    "topn_det": dict(N=50, w=8),
    "topn_rand": dict(d=128, w=4),
    "distinct": dict(d=64, w=4),
    "skyline": dict(w=8),
    "groupby": dict(d=16, w=4, agg="count"),
    "having": dict(threshold=40, rows=3, width=512, agg="count"),
}
STATS = ("batches", "entries", "merges")


def _streams(algo, seed=0, m=M):
    rng = np.random.default_rng(seed)
    if algo in ("topn_det", "topn_rand"):
        return (rng.random(m).astype(np.float32) * 1e4 + 1,)
    if algo == "distinct":
        return (rng.integers(1, 400, m).astype(np.uint32),)
    if algo == "skyline":
        return (rng.random((m, 3)).astype(np.float32) * 100,)
    return (rng.integers(0, 64, m).astype(np.uint32),
            rng.integers(1, 50, m).astype(np.int32))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(t, j):
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def _fold_all(stream, streams, sizes, to):
    lo = 0
    for b in sizes:
        stream.fold(*(to(s[lo:lo + b]) for s in streams))
        lo += b
    return stream.close()


@functools.lru_cache(maxsize=None)
def _jax_run(algo, merge_every, seed=0):
    s = JS.PruneStream(algo, shards=SHARDS, merge_every=merge_every,
                       obs="off", **PARAMS[algo])
    res = _fold_all(s, _streams(algo, seed), SIZES, jnp.asarray)
    return res, [np.asarray(m) for m in s.live_masks()]


def _torch_stream(algo, **kw):
    kw.setdefault("obs", "off")
    return TS.PruneStream(algo, shards=SHARDS, **kw, **PARAMS[algo])


def _run(algo, seed=0, sizes=SIZES, **kw):
    s = _torch_stream(algo, **kw)
    return s, _fold_all(s, _streams(algo, seed), sizes, torch.from_numpy)


def _state_eq(tstate, jstate):
    """Every field both merged states have (DISTINCT's owner shards are a
    property of the port's, from its column count)."""
    for f in vars(jstate):
        jv = getattr(jstate, f)
        if isinstance(jv, int):
            assert getattr(tstate, f) == jv
        else:
            _eq(getattr(tstate, f), jv)


@pytest.mark.parametrize("algo", list(PARAMS))
@pytest.mark.parametrize("merge_every", [1, 3])
def test_stream_matches_the_reference(algo, merge_every):
    jres, jlive = _jax_run(algo, merge_every)
    stream, res = _run(algo, merge_every=merge_every)
    _eq(res.keep, jres.keep)
    _eq(res.live_keep, jres.live_keep)
    _state_eq(res.state, jres.state)
    if jres.emitted is None:
        assert res.emitted is None
    else:
        for t, j in zip(res.emitted, jres.emitted):
            _eq(t, j)
    assert {k: res.stats[k] for k in STATS} == \
        {k: jres.stats[k] for k in STATS}
    assert res.stats["window_blocks"] == 0   # every CPU mask is ready
    for t, j in zip(stream.live_masks(), jlive):
        _eq(t, j)


@pytest.mark.parametrize("algo", list(PARAMS))
def test_close_equals_one_shot_on_the_lane_view(algo):
    """close().keep == one-shot two_pass on the lane-view stream, and the
    port's lane_view is the reference's."""
    streams = _streams(algo, 1)
    _, res = _run(algo, seed=1, merge_every=3)
    lv, valid, arrival = TS.lane_view(
        algo, [torch.from_numpy(s) for s in streams], SIZES, SHARDS,
        **PARAMS[algo])
    jlv, jvalid, jarrival = JS.lane_view(algo, streams, SIZES, SHARDS,
                                         **PARAMS[algo])
    for t, j in zip(lv, jlv):
        _eq(t, j)
    _eq(valid, jvalid)
    _eq(arrival, jarrival)
    one = T.engine_prune(algo, *lv, mode="two_pass", shards=SHARDS,
                         obs="off", **PARAMS[algo])
    assert torch.equal(res.keep[arrival[valid]], one.keep[valid])


def test_lane_states_update_in_place():
    """The fold writes the lane states in place (their data_ptr stay); with
    donate=False every fold allocates a fresh state."""
    vals = _streams("distinct", 5, m=4096)[0]
    s = _torch_stream("distinct", merge_every=4)
    s.fold(torch.from_numpy(vals[:1024]))
    ptrs = [t.data_ptr() for t in (s.lane_state.slots, s.lane_state.valid,
                                   s.lane_state.head)]
    for lo in range(1024, 4096, 1024):
        s.fold(torch.from_numpy(vals[lo:lo + 1024]))
    assert ptrs == [t.data_ptr() for t in (s.lane_state.slots,
                                           s.lane_state.valid,
                                           s.lane_state.head)]
    s2 = _torch_stream("distinct", merge_every=4, donate=False)
    s2.fold(torch.from_numpy(vals[:1024]))
    before = s2.lane_state.slots.data_ptr()
    s2.fold(torch.from_numpy(vals[1024:2048]))
    assert s2.lane_state.slots.data_ptr() != before


@pytest.mark.parametrize("algo", ["distinct", "groupby"])
def test_merged_snapshot_never_aliases_the_lanes(algo):
    """At S = 1 the column union is a view of the lane state; the stream's
    snapshot must not be, or the next fold would rewrite it."""
    streams = _streams(algo, 2)
    s = TS.PruneStream(algo, shards=1, merge_every=1, obs="off",
                       **PARAMS[algo])
    s.fold(*(torch.from_numpy(x[:600]) for x in streams))
    snap = {k: v.clone() for k, v in vars(s._merged).items()
            if isinstance(v, torch.Tensor)}
    lanes = {t.untyped_storage().data_ptr() for t in vars(s.lane_state)
             .values() if isinstance(t, torch.Tensor)}
    assert not lanes & {v.untyped_storage().data_ptr() for v in
                        vars(s._merged).values()
                        if isinstance(v, torch.Tensor)}
    merged = s._merged
    s.merge_every, s._merge_k = 10, 10   # no merge in the next fold
    s.fold(*(torch.from_numpy(x[600:]) for x in streams))
    for k, v in snap.items():
        assert torch.equal(getattr(merged, k), v)


def test_retain_false_returns_the_live_masks():
    vals = _streams("distinct", 8, m=2048)[0]
    s = _torch_stream("distinct", merge_every=1, retain=False)
    s.fold(torch.from_numpy(vals[:1024]))
    s.fold(torch.from_numpy(vals[1024:]))
    res = s.close()
    assert torch.equal(res.keep, res.live_keep)
    assert all(rec["lanes"] is None for rec in s._batches)
    j = JS.PruneStream("distinct", shards=SHARDS, merge_every=1,
                       retain=False, obs="off", **PARAMS["distinct"])
    j.fold(jnp.asarray(vals[:1024]))
    j.fold(jnp.asarray(vals[1024:]))
    _eq(res.keep, j.close().keep)


def test_reset_starts_a_fresh_stream():
    streams = _streams("topn_rand", 3)
    s = _torch_stream("topn_rand", merge_every=2)
    _fold_all(s, streams, SIZES[:2], torch.from_numpy)
    s.reset()
    res = _fold_all(s, streams, SIZES, torch.from_numpy)
    _, fresh = _run("topn_rand", seed=3, merge_every=2)
    assert torch.equal(res.keep, fresh.keep)
    assert torch.equal(res.state.vals, fresh.state.vals)


def test_window_bounds_the_masks_in_flight():
    vals = _streams("distinct", 6, m=8 * 1024)[0]
    s = _torch_stream("distinct", merge_every=1, window=2)
    for lo in range(0, vals.shape[0], 1024):
        s.fold(torch.from_numpy(vals[lo:lo + 1024]))
        assert s.in_flight <= 2
    assert s.close().stats["batches"] == 8


def test_engine_prune_stream_matches_the_reference():
    (v,) = _streams("topn_det", 7, m=4000)
    res = TS.engine_prune_stream("topn_det", torch.from_numpy(v),
                                 micro_batch=1024, shards=SHARDS,
                                 merge_every=1, obs="off",
                                 **PARAMS["topn_det"])
    jres = JS.engine_prune_stream("topn_det", v, micro_batch=1024,
                                  shards=SHARDS, merge_every=1, obs="off",
                                  **PARAMS["topn_det"])
    _eq(res.keep, jres.keep)
    _eq(res.live_keep, jres.live_keep)
    assert res.keep.shape == (4000,)


@pytest.mark.parametrize("algo", ["topn_det", "distinct"])
def test_dict_encoded_stream_matches_the_reference(algo):
    """One dictionary-encoded case each: codes in, the pads as codes, the
    same masks and state as the reference's encoded stream."""
    (x,) = _streams(algo, 9)
    x = (x % 97).astype(x.dtype) if algo == "distinct" else \
        np.round(x / 100).astype(np.float32)
    jcodes, jenc = jdict_encode(jnp.asarray(x))
    codes, enc = T.dict_encode(torch.from_numpy(x))
    _eq(codes, jcodes)
    kw = dict(shards=SHARDS, merge_every=3, obs="off", **PARAMS[algo])
    j = JS.PruneStream(algo, encoding=jenc, **kw)
    t = TS.PruneStream(algo, encoding=enc, **kw)
    jres = _fold_all(j, (np.asarray(jcodes),), SIZES, jnp.asarray)
    res = _fold_all(t, (codes.numpy(),), SIZES, torch.from_numpy)
    _eq(res.keep, jres.keep)
    _eq(res.live_keep, jres.live_keep)
    _state_eq(res.state, jres.state)


def test_mesh_and_unknowns_raise():
    with pytest.raises(ValueError, match="divisible"):
        TS.PruneStream("distinct", shards=3, mesh=T.Mesh(("cpu",) * 2),
                       d=8, w=2)
    with pytest.raises(KeyError):
        TS.PruneStream("median")
    with pytest.raises(ValueError, match="mode"):
        TS.PruneStream("distinct", options=T.ExecOptions(mode="scan"),
                       d=8, w=2)
    s = TS.PruneStream("distinct", shards=2, d=8, w=2, obs="off")
    with pytest.raises(ValueError, match="empty"):
        s.fold(torch.zeros(0, dtype=torch.int32).view(torch.uint32))
    with pytest.raises(RuntimeError, match="nothing folded"):
        s.merge()
    assert TS.default_shards() >= 1


def test_stream_report_counts_merges_and_staleness():
    """obs="counters": the stream's report counts its entries, merges and
    the bytes each merge reads, and observes staleness and the window."""
    streams = _streams("topn_rand", 4)
    s = TS.PruneStream("topn_rand", shards=SHARDS, merge_every=3,
                       obs="counters", **PARAMS["topn_rand"])
    res = _fold_all(s, streams, SIZES, torch.from_numpy)
    c = res.report.counters
    assert c["entries_scanned"] == M
    assert c["entries_kept"] == int(res.keep.sum())
    assert c["merge_collective_count"] == res.stats["merges"] == 2
    # one device: each merge reads the S stacked lane states once (the
    # reference's all_gather ships them to each of its D devices)
    assert c["state_bytes_shipped"] == 2 * SHARDS * 128 * 4 * 4
    j = JS.PruneStream("topn_rand", shards=SHARDS, merge_every=3,
                       obs="counters", **PARAMS["topn_rand"])
    jc = _fold_all(j, streams, SIZES, jnp.asarray).report.counters
    for k in ("entries_scanned", "entries_kept", "merge_collective_count",
              "snapshot_staleness_batches_max"):
        assert c[k] == jc[k]
    assert c["window_occupancy_max"] == 0
