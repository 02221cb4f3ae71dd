"""The port's ``ExecOptions`` against the JAX package's.

``ExecOptions.resolve`` merges the same keyword arguments into the same
bundle in both packages (options= wins, and a conflict warns), the same
values are refused, and ``options=`` gives ``engine_prune`` and
``run_query`` the masks of the equivalent keyword arguments, bit for bit,
which equal the reference's on the same numpy-seeded streams.
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_prune as j_engine
from repro.core.options import ExecOptions as JOptions
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import ExecOptions, convert, obs
from repro_torch.core import engine as tengine
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


RESOLVE = [
    (None, {}),
    (None, dict(mode="two_pass", shards=4)),
    (dict(mode="two_pass"), {}),
    (dict(mode="two_pass"), dict(shards=16, decode="eager")),
    (dict(mode="sharded", shards="auto"), dict(mode="sharded")),
    (dict(obs="trace", decode="late"), dict(obs="off")),
    (dict(shards=8), dict(shards=4)),
    (dict(apply_block=64, pass2="master"), dict(tune="off")),
]


@pytest.mark.parametrize("ri", range(len(RESOLVE)))
def test_resolve_matches_reference(ri):
    opts, kw = RESOLVE[ri]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = JOptions.resolve(None if opts is None else JOptions(**opts),
                                **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = ExecOptions.resolve(None if opts is None
                                  else ExecOptions(**opts), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert [w.category for w in tw] == [w.category for w in jw]


def test_field_names_and_refusals_match_reference():
    assert [f.name for f in dataclasses.fields(ExecOptions)] == \
        [f.name for f in dataclasses.fields(JOptions)]
    for bad in (dict(decode="lazy"), dict(obs="loud")):
        for cls in (ExecOptions, JOptions):
            with pytest.raises(ValueError):
                cls(**bad)
    for mod in (ExecOptions, JOptions):
        with pytest.raises(TypeError, match="ExecOptions"):
            mod.resolve(object(), mode="scan")
        with pytest.raises(ValueError, match="does not accept"):
            mod(mode="scan").require_unset("x", "shards", "mode")
        mod(tune="off").require_unset("x", "mode", "shards")
    with pytest.raises(dataclasses.FrozenInstanceError):
        ExecOptions().mode = "scan"


def _case(name, seed=0):
    rs = np.random.default_rng(seed)
    if name == "topn_rand":
        return "topn_rand", ((rs.random(3000) * 1e4).astype(np.float32),), \
            dict(d=32, w=4)
    if name == "distinct":
        return "distinct", (rs.integers(1, 300, 3001).astype(np.uint32),), \
            dict(d=16, w=4)
    if name == "skyline":
        return "skyline", (rs.integers(1, 300, (1500, 2)).astype(
            np.float32),), dict(w=4)
    keys = rs.integers(0, 40, 2999).astype(np.uint32)
    return "having", (keys, rs.integers(1, 50, 2999).astype(np.int32)), \
        dict(threshold=120, rows=3, width=128)


@pytest.mark.parametrize("mode,extra", [("scan", {}),
                                        ("sharded", dict(shards=4)),
                                        ("two_pass", dict(shards=8,
                                                          apply_block=64))])
@pytest.mark.parametrize("name", ["topn_rand", "distinct", "skyline",
                                  "having"])
def test_options_give_the_masks_of_the_kwargs(name, mode, extra):
    algo, xs, p = _case(name)
    tx = tuple(torch.from_numpy(x) for x in xs)
    by_kw = tengine.engine_prune(algo, *tx, mode=mode, obs="off", **extra,
                                 **p)
    opts = ExecOptions(mode=mode, obs="counters", **extra)
    by_opts = tengine.engine_prune(algo, *tx, options=opts, **p)
    np.testing.assert_array_equal(by_opts.keep.numpy(), by_kw.keep.numpy())
    assert by_kw.report is None and by_opts.report is not None
    assert by_opts.report.meta["mode"] == mode
    want = j_engine(algo, *(jnp.asarray(x) for x in xs), mode=mode,
                    obs="off", **extra, **p)
    np.testing.assert_array_equal(by_opts.keep.numpy(), np.asarray(want.keep))


def test_conflict_warns_and_options_win():
    algo, xs, p = _case("distinct")
    x = torch.from_numpy(xs[0])
    with pytest.warns(UserWarning, match="options= wins"):
        r = tengine.engine_prune(algo, x, mode="scan",
                                 options=ExecOptions(mode="two_pass",
                                                     shards=4), **p)
    assert r.report.meta["mode"] == "two_pass"
    want = tengine.engine_prune(algo, x, mode="two_pass", shards=4, **p)
    np.testing.assert_array_equal(r.keep.numpy(), want.keep.numpy())


def _tables(seed=0):
    rs = np.random.default_rng(seed)
    cols = {"k": (rs.integers(0, 30, 2000) * 3).astype(np.uint32),
            "v": (rs.random(2000) * 100).astype(np.float32)}
    return (jt.Table("t", {c: jnp.asarray(a) for c, a in cols.items()}),
            convert.table_from_numpy(cols, device="cpu"))


@pytest.mark.parametrize("spec", [("topn", ("v",), dict(d=16, w=4, N=5)),
                                  ("distinct", ("k",), dict(d=8, w=2))])
def test_run_query_options(spec):
    jtab, ttab = _tables()
    want = jq.run_query(jq.QuerySpec(*spec), jtab, decode="eager",
                        obs="off")
    got = tq.run_query(tq.QuerySpec(*spec), ttab,
                       options=ExecOptions(decode="eager", obs="off"))
    np.testing.assert_array_equal(got["keep"].numpy(),
                                  np.asarray(want["keep"]))
    assert got["report"] is None
    for bad in (dict(mode="two_pass"), dict(shards=4), dict(pass2="master"),
                dict(apply_block=8)):
        for run, tab, cls, qs in ((tq.run_query, ttab, ExecOptions,
                                   tq.QuerySpec),
                                  (jq.run_query, jtab, JOptions,
                                   jq.QuerySpec)):
            with pytest.raises(ValueError, match="run_query"):
                run(qs(*spec), tab, options=cls(**bad))
    # tune= through options= races a plan; the answer is tune="off"'s
    tuned = tq.run_query(tq.QuerySpec(*spec), ttab,
                         options=ExecOptions(tune="race", obs="off"))
    plain = tq.run_query(tq.QuerySpec(*spec), ttab, obs="off")
    for a, b in zip(*(r["output"] if isinstance(r["output"], tuple)
                      else (r["output"],) for r in (tuned, plain))):
        assert torch.equal(a, b)
