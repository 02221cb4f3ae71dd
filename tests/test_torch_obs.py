"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

The same numpy-seeded streams go through ``repro.core.engine_prune`` and
``repro_torch.core.engine_prune`` (and ``run_query``) on the CPU:

* the port's keep masks are bit-identical at ``obs="off"``, ``"counters"``
  and ``"trace"``, and equal to the reference's;
* the ``ExecReport`` counters and annotations equal the reference's
  exactly (counts are integers; ``prune_ratio`` and ``decode_skipped_ratio``
  are the same Python float expression of them), and so does the
  process-wide ``REGISTRY`` snapshot after the same calls (engine calls
  record no histograms, so no wall time enters it);
* Chrome traces round-trip through JSON, and spans nest.
"""
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import engine_prune as j_engine
from repro.core.encoding import dict_encode as j_dict_encode
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import ExecOptions, ExecReport, convert, obs
from repro_torch.core import engine as tengine
from repro_torch.core.encoding import dict_encode as t_dict_encode
from repro_torch.query import engine as tq


@pytest.fixture(autouse=True)
def _reset_port():
    """The port's process-wide caches and telemetry, reset around each test
    (the shared conftest resets the JAX package's)."""
    tengine.reset_caches()
    obs.REGISTRY.reset()
    obs.TRACER.reset()
    yield
    tengine.reset_caches()
    obs.REGISTRY.reset()
    obs.TRACER.reset()


NAMES = ("topn_det", "topn_rand", "distinct_lru", "distinct_fifo", "skyline",
         "groupby", "having")


def _case(name, seed=0):
    """(algo, numpy streams, params) of one of the seven algorithm forms."""
    rs = np.random.default_rng(seed)
    if name == "topn_det":
        return "topn_det", ((rs.random(3001) * 1e5 + 1).astype(np.float32),), \
            dict(N=25, w=6)
    if name == "topn_rand":
        return "topn_rand", ((rs.permutation(4000) + 1).astype(np.float32),), \
            dict(d=64, w=8, seed=seed)
    if name in ("distinct_lru", "distinct_fifo"):
        return "distinct", (rs.integers(1, 250, 2999).astype(np.uint32),), \
            dict(d=32, w=4, policy=name.split("_")[1])
    if name == "skyline":
        return "skyline", (rs.integers(1, 400, (1501, 3)).astype(
            np.float32),), dict(w=8)
    keys = rs.integers(0, 40, 2998).astype(np.uint32)
    vals = rs.integers(1, 50, 2998).astype(np.int32)
    if name == "groupby":
        return "groupby", (keys, vals), dict(d=16, w=4, agg="sum")
    return "having", (keys, vals), dict(threshold=150, rows=3, width=256)


def _same_report(t: ExecReport, j) -> None:
    assert t.entry == j.entry
    assert t.meta == j.meta
    assert t.counters == j.counters
    assert t.wall_us > 0


def _snapshot(registry) -> dict:
    return {k: v for k, v in registry.snapshot().items()
            if not isinstance(v, dict)}


@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("name", NAMES)
def test_reports_match_reference_and_levels_agree(name, mode):
    algo, xs, p = _case(name)
    jx = tuple(jnp.asarray(x) for x in xs)
    tx = tuple(torch.from_numpy(x) for x in xs)
    kw = dict(mode=mode, shards=4, **p)
    j_off = j_engine(algo, *jx, obs="off", **kw)
    t_off = tengine.engine_prune(algo, *tx, obs="off", **kw)
    assert t_off.report is None
    assert obs.REGISTRY.snapshot() == {}
    j_cnt = j_engine(algo, *jx, obs="counters", **kw)
    t_cnt = tengine.engine_prune(algo, *tx, obs="counters", **kw)
    _same_report(t_cnt.report, j_cnt.report)
    assert _snapshot(obs.REGISTRY) == _snapshot(jobs.REGISTRY)
    t_trc = tengine.engine_prune(algo, *tx, obs="trace", **kw)
    for r in (t_off, t_cnt, t_trc):
        np.testing.assert_array_equal(r.keep.numpy(), np.asarray(j_off.keep))
    kept = int(t_cnt.keep.sum())
    assert t_cnt.report.entries_kept == kept
    assert t_cnt.report.entries_scanned == xs[0].shape[0]
    assert t_cnt.report.counters == t_trc.report.counters
    names = {e["name"] for e in t_trc.report.spans}
    if mode == "scan":
        assert names == {"engine_prune.scan"}
        assert t_cnt.report.merge_collective_count == 0
    elif mode == "sharded" and algo != "having":
        assert names == {"engine_prune.pass1"}
    else:
        assert names == {"engine_prune.pass1", "engine_prune.gather_merge",
                         "engine_prune.pass2_apply"}
        assert t_cnt.report.merge_collective_count == 1
        assert t_cnt.report.state_bytes_shipped > 0
    assert not t_cnt.report.spans


@pytest.mark.parametrize("mode", ["scan", "two_pass"])
@pytest.mark.parametrize("name", ["topn_det", "distinct_lru", "having"])
def test_encoded_reports_match_reference(name, mode):
    """Dictionary-encoded stream 0: the report adds decode_skipped_ratio."""
    algo, xs, p = _case(name, seed=2)
    col = xs[0] % 97 if xs[0].dtype != np.float32 else np.round(xs[0] % 97)
    xs = (col.astype(xs[0].dtype),) + xs[1:]
    jc, je = j_dict_encode(jnp.asarray(xs[0]))
    tc, te = t_dict_encode(torch.from_numpy(xs[0]))
    jx = (jc,) + tuple(jnp.asarray(x) for x in xs[1:])
    tx = (tc,) + tuple(torch.from_numpy(x) for x in xs[1:])
    kw = dict(mode=mode, shards=4, obs="counters", **p)
    want = j_engine(algo, *jx, encoding=je, **kw)
    got = tengine.engine_prune(algo, *tx, encoding=te, **kw)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    _same_report(got.report, want.report)
    assert "decode_skipped_ratio" in got.report.counters
    assert _snapshot(obs.REGISTRY) == _snapshot(jobs.REGISTRY)


def _tables(seed=0):
    rs = np.random.default_rng(seed)
    cols = {"k": rs.integers(0, 50, 3000).astype(np.uint32),
            "v": (rs.random(3000) * 100).astype(np.float32),
            "u": rs.integers(0, 40, 3000).astype(np.uint32)}
    return (jt.Table("t", {c: jnp.asarray(a) for c, a in cols.items()}),
            convert.table_from_numpy(cols, device="cpu"))


SPECS = [
    ("topn", ("v",), dict(d=32, w=4, N=10)),
    ("topn", ("v",), dict(N=10, w=4, mode="det")),
    ("distinct", ("k",), dict(d=16, w=4)),
    ("having", ("k", "v"), dict(threshold=500.0, rows=3, width=64)),
    ("groupby", ("k", "v"), dict(d=8, w=2)),
]


@pytest.mark.parametrize("si", range(len(SPECS)))
def test_run_query_report_matches_reference(si):
    jtab, ttab = _tables()
    spec = SPECS[si]
    want = jq.run_query(jq.QuerySpec(*spec), jtab, obs="counters")
    got = tq.run_query(tq.QuerySpec(*spec), ttab, obs="counters")
    assert isinstance(got["report"], ExecReport)
    _same_report(got["report"], want["report"])
    assert _snapshot(obs.REGISTRY) == _snapshot(jobs.REGISTRY)
    for lvl in ("off", "trace"):
        r = tq.run_query(tq.QuerySpec(*spec), ttab, obs=lvl)
        np.testing.assert_array_equal(r["keep"].numpy(), got["keep"].numpy())
        assert (r["report"] is None) == (lvl == "off")


def test_run_query_join_and_filter_have_no_report():
    from repro_torch.core import Pred

    jtab, ttab = _tables()
    got = tq.run_query(tq.QuerySpec("join", ("k", "u"), dict(nbits=4096)),
                       (ttab, ttab), obs="trace")
    assert got["report"] is None
    got = tq.run_query(tq.QuerySpec("filter", ("v",), dict(
        formula=Pred("v", "gt", 50.0))), ttab, obs="counters")
    assert got["report"] is None


def test_chrome_trace_roundtrips_and_is_valid(tmp_path):
    algo, xs, p = _case("topn_det")
    tengine.engine_prune(algo, torch.from_numpy(xs[0]), mode="two_pass",
                         shards=4, obs="trace", **p)
    back = json.loads(json.dumps(obs.TRACER.chrome_trace()))
    assert back["displayTimeUnit"] == "ms"
    evs = back["traceEvents"]
    assert [e["name"] for e in evs] == ["engine_prune.pass1",
                                        "engine_prune.gather_merge",
                                        "engine_prune.pass2_apply"]
    for e in evs:
        assert e["ph"] == "X"
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        assert "pid" in e and "tid" in e and e["args"]["depth"] == 0
    out = tmp_path / "trace.json"
    obs.TRACER.write(out)
    assert json.loads(out.read_text())["traceEvents"] == evs


def test_spans_nest():
    tr = obs.Tracer()
    with tr.span("outer"):
        with tr.span("inner"):
            with tr.span("leaf"):
                pass
        with tr.span("inner2", args={"k": 1}):
            pass
    by = {e["name"]: e for e in tr.events()}
    assert [by[n]["args"]["depth"] for n in ("outer", "inner", "leaf",
                                              "inner2")] == [0, 1, 2, 1]
    assert by["inner2"]["args"]["k"] == 1
    for child in ("inner", "leaf", "inner2"):
        assert by[child]["ts"] >= by["outer"]["ts"]
        assert (by[child]["ts"] + by[child]["dur"]
                <= by["outer"]["ts"] + by["outer"]["dur"] + 1.0)
    # an engine call's spans nest under a caller's
    algo, xs, p = _case("distinct_fifo")
    with obs.TRACER.span("caller"):
        tengine.engine_prune(algo, torch.from_numpy(xs[0]), mode="two_pass",
                             shards=4, obs="trace", **p)
    depth = {e["name"]: e["args"]["depth"] for e in obs.TRACER.events()}
    assert depth == {"caller": 0, "engine_prune.pass1": 1,
                     "engine_prune.gather_merge": 1,
                     "engine_prune.pass2_apply": 1}


def test_registry_routes_ratios_to_gauges_as_the_reference():
    for mod in (obs, jobs):
        r = mod.Registry()
        r.record("x.entries_scanned", 10)
        r.record("x.entries_scanned", 5)
        r.record("x.prune_ratio", 0.75)
        snap = r.snapshot()
        assert snap == {"x.entries_scanned": 15, "x.prune_ratio": 0.75}
        assert isinstance(r.counter("x.entries_scanned"), mod.metrics.Counter)
        assert isinstance(r.gauge("x.prune_ratio"), mod.metrics.Gauge)


def test_registry_histogram_summary_as_the_reference():
    hs = []
    for mod in (obs, jobs):
        r = mod.Registry()
        h = r.histogram("lat")
        for v in range(700):
            h.observe(float(v % 101))
        hs.append((h.summary(), h.percentile(50), h.percentile(99), h.mean))
        r.reset()
        assert r.snapshot() == {}
    assert hs[0] == hs[1]
    assert hs[0][0]["count"] == 700 and hs[0][0]["max"] == 100.0


def test_recorder_off_and_under_compilation_is_null(monkeypatch):
    assert obs.recorder("x", "off") is obs.NULL
    assert not obs.NULL.active and obs.NULL.finish() is None
    assert obs.NULL.sync(3) == 3
    assert isinstance(obs.recorder("x", "counters"), obs.Recorder)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert obs.recorder("x", "trace") is obs.NULL
    with pytest.raises(ValueError, match="obs level"):
        obs.recorder("x", "loud")


def test_recorder_counts_like_the_reference():
    reps = []
    for mod in (obs, jobs):
        mod.REGISTRY.reset()
        rec = mod.Recorder("e", "counters")
        rec.count("entries_scanned", 10)
        rec.count("entries_kept", 4)
        rec.count("state_bytes_shipped", 64)
        rec.count("state_bytes_shipped", 64)
        rec.observe("window", 3)
        rec.observe("window", 1)
        rec.annotate(algo="x", shards=2)
        reps.append((rec.finish(), mod.REGISTRY.snapshot()))
        mod.REGISTRY.reset()
    (t, ts), (j, js) = reps
    assert (t.meta, t.counters) == (j.meta, j.counters)
    assert t.counters["prune_ratio"] == 0.6
    assert ts == js


def test_options_validate_obs_level_and_default_level():
    with pytest.raises(ValueError, match="obs"):
        ExecOptions(obs="verbose")
    for lvl in obs.OBS_MODES:
        assert ExecOptions(obs=lvl).obs == lvl
    assert obs.OBS_MODES == jobs.OBS_MODES
    assert obs.default_level() == jobs.default_level() == "counters"
    obs.set_default_level("off")
    try:
        assert obs.default_level() == "off"
        algo, xs, p = _case("topn_rand")
        assert tengine.engine_prune(algo, torch.from_numpy(xs[0]),
                                    **p).report is None
        with pytest.raises(ValueError):
            obs.set_default_level("loud")
    finally:
        obs.set_default_level("counters")
    assert tengine.engine_prune(algo, torch.from_numpy(xs[0]),
                                **p).report is not None


def test_trace_sync_is_the_identity_on_the_cpu():
    rec = obs.Recorder("x", "trace")
    t = torch.arange(4)
    assert rec.sync(t) is t
    assert rec.sync((t, None)) is not None
    assert obs.report._cuda_device((t, [t])) is None


def test_structured_logger_names_and_env_level(monkeypatch):
    assert obs.get_logger("core.engine").name == "repro_torch.core.engine"
    assert obs.get_logger().name == "repro_torch"
    assert obs.get_logger("repro_torch.x").name == "repro_torch.x"
    monkeypatch.setenv(obs.log.ENV_VAR, "DEBUG")
    obs.log.configure(force=True)
    assert logging.getLogger("repro_torch").level == logging.DEBUG
    monkeypatch.delenv(obs.log.ENV_VAR)
    obs.log.configure(force=True)
    assert logging.getLogger("repro_torch").level == logging.WARNING


def test_warn_dual_emits():
    records = []
    h = logging.Handler()
    h.emit = records.append
    lg = logging.getLogger("repro_torch")
    lg.addHandler(h)
    try:
        with pytest.warns(UserWarning, match="both channels"):
            obs.log.warn("goes to both channels", logger="core.test")
    finally:
        lg.removeHandler(h)
    assert any("both channels" in r.getMessage() for r in records)
    assert records[0].name == "repro_torch.core.test"


def test_report_summary_is_printable():
    algo, xs, p = _case("topn_det")
    r = tengine.engine_prune(algo, torch.from_numpy(xs[0]), mode="two_pass",
                             shards=4, obs="trace", **p)
    s = r.report.summary()
    assert "ExecReport[engine_prune]" in s
    assert "entries_scanned" in s and "prune_ratio" in s
    assert "span engine_prune.pass1" in s
