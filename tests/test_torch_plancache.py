"""The port's plan cache against the JAX package's.

``cache_key`` equals the reference's in every field but the device field
(``torch-<type>x<count>`` against the JAX backend's ``<backend>x<count>``),
``m_bucket`` and ``distribution_fingerprint`` are equal on every stream
form, and the durability cases of the reference's own tests (schema,
corruption, eviction, atomic writes) hold in both packages, with ``stats()``
and the ``plancache.*`` counters equal.
"""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import plancache as jpc
from repro.core import planner as jp
from repro_torch import obs as tobs
from repro_torch.core import engine as tengine
from repro_torch.core import plancache as tpc
from repro_torch.core import planner as tp

PACKAGES = {"jax": (jpc, jobs), "torch": (tpc, tobs)}
PLAN = tp.Plan(mode="two_pass", shards=8).to_dict()


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


def _streams(form, m, seed=0):
    """numpy streams of one form: uint32, int32, float32, [m, 2] points, a
    pair of key and value streams, a bool validity column."""
    rs = np.random.default_rng(seed)
    if form == "uint32":
        return (rs.integers(0, 1 << 32, m, dtype=np.uint64).astype(
            np.uint32),)
    if form == "uint32 few":
        return (rs.integers(0, 5, m).astype(np.uint32),)
    if form == "int32":
        return (rs.integers(-1000, 1000, m).astype(np.int32),)
    if form == "float32":
        return ((rs.standard_normal(m) * 1e4).astype(np.float32),)
    if form == "points":
        return (rs.integers(1, 400, (m, 2)).astype(np.float32),)
    if form == "pair":
        return (rs.integers(0, 40, m).astype(np.uint32),
                rs.integers(1, 50, m).astype(np.int32))
    assert form == "triple"
    return (rs.integers(0, 40, m).astype(np.uint32),
            rs.random(m).astype(np.float32), rs.random(m) < 0.7)


FORMS = ("uint32", "uint32 few", "int32", "float32", "points", "pair",
         "triple")


def _both(xs):
    return (tuple(jnp.asarray(x) for x in xs),
            tuple(torch.from_numpy(x) for x in xs))


@pytest.mark.parametrize("m", [1, 3, 1000, 2048, 2500, 1 << 12])
@pytest.mark.parametrize("form", FORMS)
def test_fingerprint_and_bucket_match(form, m):
    jx, tx = _both(_streams(form, m))
    assert tpc.distribution_fingerprint(tx) == \
        jpc.distribution_fingerprint(jx)
    assert tpc.m_bucket(m) == jpc.m_bucket(m)


@pytest.mark.parametrize("params", [dict(N=8), dict(d=64, w=4, seed=3),
                                    dict(d=64, w=4, policy="fifo"),
                                    dict(threshold=1.5, agg="sum",
                                         extra=[1, 2])])
@pytest.mark.parametrize("form", FORMS)
def test_cache_key_matches_but_for_the_device(form, params):
    jx, tx = _both(_streams(form, 3001, seed=4))
    jk = jpc.cache_key("algo", jx, params).split("|")
    tk = tpc.cache_key("algo", tx, params).split("|")
    assert tk[:-1] == jk[:-1]
    assert tk[-1] == "torch-cpux1" != jk[-1]
    # None streams drop out, as in the reference
    assert tpc.cache_key("algo", tx + (None,), params) == "|".join(tk)


def test_cache_key_discriminates():
    rs = np.random.default_rng(0)
    x = torch.from_numpy(rs.integers(1, 100, 2048).astype(np.float32))
    k1 = tpc.cache_key("topn_det", (x,), dict(N=8))
    assert k1 == tpc.cache_key("topn_det", (x,), dict(N=8))
    assert k1 != tpc.cache_key("distinct", (x,), dict(N=8))
    assert k1 != tpc.cache_key("topn_det", (x,), dict(N=16))
    assert k1 != tpc.cache_key("topn_det", (x[:256],), dict(N=8))
    y = torch.from_numpy(rs.integers(1, 100, 2500).astype(np.float32))
    assert tpc.cache_key("topn_det", (y,), dict(N=8)) == k1
    assert tpc.device_fingerprint("cpu") == "torch-cpux1"


@pytest.fixture(params=list(PACKAGES))
def pkg(request, tmp_path):
    """(plancache module, obs package, a cache in a fresh file) of one
    package."""
    pc, obs = PACKAGES[request.param]
    return pc, obs, pc.PlanCache(tmp_path / "plans.json")


def _outcome(pkg, case, tmp_path, monkeypatch):
    """What one durability case leaves: its observations, stats() and the
    plancache.* counters of the package's registry."""
    pc, obs, cache = pkg
    seen = []
    if case == "round trip":
        cache.put("k1", PLAN, algo="topn_det", speedup_x=2.0)
        e = cache.get("k1")
        seen += [e["plan"], e["algo"], e["saved_at"] > 0,
                 pc.PlanCache(cache.path).get("k1")["plan"]]
    elif case == "missing file":
        seen += [cache.load(), cache.get("nope")]
    elif case == "corrupt file":
        cache.path.write_text("{not json at all")
        with pytest.warns(UserWarning, match="unreadable"):
            seen.append(cache.load())
        with pytest.warns(UserWarning, match="unreadable"):
            cache.put("k", PLAN)
        seen.append(cache.get("k")["plan"])
    elif case == "schema":
        cache.path.write_text(json.dumps(
            {"schema": pc.SCHEMA_VERSION + 1,
             "plans": {"k": {"plan": PLAN}}}))
        with pytest.warns(UserWarning, match="schema"):
            seen.append(cache.get("k"))
    elif case == "foreign json":
        cache.path.write_text(json.dumps([1, 2, 3]))
        with pytest.warns(UserWarning, match="schema"):
            seen.append(cache.load())
    elif case == "malformed entry":
        cache.put("good", PLAN)
        raw = json.loads(cache.path.read_text())
        raw["plans"]["bad"] = {"plan": "not-a-dict"}
        raw["plans"]["worse"] = 42
        cache.path.write_text(json.dumps(raw))
        seen += [cache.get("bad"), cache.get("worse"),
                 cache.get("good")["plan"]]
    elif case == "atomic writes":
        for i in range(5):
            cache.put(f"k{i}", PLAN)
        seen.append(sorted(p.name for p in cache.path.parent.iterdir()))
        raw = json.loads(cache.path.read_text())
        seen += [raw["schema"], sorted(raw["plans"])]
    elif case == "interleaved writers":
        pc.PlanCache(cache.path).put("from_a", PLAN)
        pc.PlanCache(cache.path).put("from_b", PLAN)
        seen.append(sorted(pc.PlanCache(cache.path).load()))
    elif case == "threaded writers":
        def work(tag):
            for i in range(10):
                cache.put(f"{tag}{i}", PLAN)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("x", "y", "z")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        seen.append([t.is_alive() for t in threads])
        raw = json.loads(cache.path.read_text())
        seen += [raw["schema"], all(isinstance(v["plan"], dict)
                                    for v in raw["plans"].values())]
        return seen, None, None  # the interleaving sets the counts
    elif case == "eviction":
        monkeypatch.setattr(pc, "MAX_ENTRIES", 3)
        times = iter(range(100))
        monkeypatch.setattr(pc.time, "time", lambda: next(times))
        for i in range(6):
            cache.put(f"k{i}", PLAN)
        seen.append(sorted(cache.load()))
    elif case == "env var":
        monkeypatch.setenv(pc.ENV_VAR, str(tmp_path / "pc.json"))
        pc.PlanCache().put("k", PLAN)
        seen.append((tmp_path / "pc.json").exists())
    elif case == "clear":
        cache.put("k", PLAN)
        cache.clear()
        cache.clear()
        seen.append(cache.path.exists())
    counters = {k: v for k, v in obs.REGISTRY.snapshot().items()
                if k.startswith("plancache.")}
    return seen, cache.stats(), counters


CASES = ("round trip", "missing file", "corrupt file", "schema",
         "foreign json", "malformed entry", "atomic writes",
         "interleaved writers", "threaded writers", "eviction", "env var",
         "clear")


@pytest.mark.parametrize("case", CASES)
def test_durability_matches(case, tmp_path, monkeypatch):
    out = {}
    for name, (pc, obs) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        obs.REGISTRY.reset()
        out[name] = _outcome((pc, obs, pc.PlanCache(d / "plans.json")),
                             case, d, monkeypatch)
    assert out["torch"] == out["jax"]
    if case == "eviction":
        assert out["torch"][0] == [["k3", "k4", "k5"]]
        assert out["torch"][1]["evictions"] == 3


def test_missing_file_is_empty_without_warning(pkg, recwarn):
    _, _, cache = pkg
    assert cache.load() == {} and cache.get("nope") is None
    assert not [w for w in recwarn.list
                if issubclass(w.category, UserWarning)]


def test_plan_dict_round_trip_and_validation():
    """Plan.from_dict accepts the reference's dicts, mesh plans included,
    and refuses each malformed one with the reference's message."""
    good = dict(mode="mesh", shards=8, pass2="mesh", apply_block=1024,
                num_devices=4)
    assert tp.Plan.from_dict(good).to_dict() == \
        jp.Plan.from_dict(good).to_dict() == good
    assert tp.Plan.from_dict(good).key() == jp.Plan.from_dict(good).key()
    for bad in (dict(good, mode="scan"), dict(good, mode="sharded"),
                dict(good, shards=1), dict(good, shards="many"),
                dict(good, pass2="nowhere"), dict(good, apply_block=-4),
                dict(good, num_devices=3), dict(good, num_devices=0), {}):
        msgs = []
        for plan in (tp.Plan, jp.Plan):
            with pytest.raises(ValueError) as e:
                plan.from_dict(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
