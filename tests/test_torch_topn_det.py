"""The port's threshold-ladder TOP-N and LRU DISTINCT against the JAX
package's.

Same numpy-seeded streams through ``repro`` and ``repro_torch`` on the CPU
(the ports' plain versions of ``topn_det_pass1`` and the LRU pass 1). Keep
masks, ladder states, caches and merged thresholds must be bit-identical:
every step of the ladder is an exact f32 minimum, a multiply by a power of
two, a compare or an integer count, and every step of the cache a compare
and a move.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core.topn import topn_det_init
from repro_torch import convert
from repro_torch import core as T
from repro_torch.constants import NEG
from repro_torch.kernels import parallel as tpar
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topn_det_scan as tds

N, W = 16, 4


def _values(kind, m, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "pos":
        return rng.gamma(2.0, 50.0, m).astype(np.float32)
    if kind == "neg":  # t0 <= 0: the ladder's levels fall, not rise
        return (rng.gamma(2.0, 50.0, m) - 120.0).astype(np.float32)
    if kind == "const":
        return np.full(m, 7.5, np.float32)
    if kind == "ascending":
        return np.arange(1, m + 1, dtype=np.float32)
    if kind == "ties":
        return rng.integers(0, 6, m).astype(np.float32)
    raise KeyError(kind)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _state_eq(t, j):
    for f in ("t0", "counts", "seen", "cur_level"):
        _eq(getattr(t, f), getattr(j, f))


KINDS = ["pos", "neg", "const", "ascending", "ties"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m", [1000, 1, 15, 16, 17, 333])
def test_topn_det_prune_matches_jax(kind, m):
    v = _values(kind, m, seed=m)
    got = T.topn_det_prune(torch.from_numpy(v), N=N, w=W)
    want = J.topn_det_prune(jnp.asarray(v), N=N, w=W)
    _eq(got.keep, want.keep)
    _state_eq(got.state, want.state)


@pytest.mark.parametrize("w", [1, 2, 8])
@pytest.mark.parametrize("n_top", [1, 100, 2000])
def test_topn_det_prune_widths_and_n(w, n_top):
    v = _values("pos", 1000, seed=w)
    got = T.topn_det_prune(torch.from_numpy(v), N=n_top, w=w)
    want = J.topn_det_prune(jnp.asarray(v), N=n_top, w=w)
    _eq(got.keep, want.keep)
    _state_eq(got.state, want.state)


def test_topn_det_nan_propagates_like_jnp_minimum():
    v = _values("pos", 200, seed=3)
    v[5] = np.nan
    got = T.topn_det_prune(torch.from_numpy(v), N=N, w=W)
    want = J.topn_det_prune(jnp.asarray(v), N=N, w=W)
    _eq(got.keep, want.keep)
    assert np.isnan(float(got.state.t0)) and np.isnan(float(want.state.t0))


@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("m", [1000, 1003])
def test_engine_topn_det_matches_jax(mode, shards, m):
    v = _values("pos" if m % 2 else "neg", m, seed=shards)
    want = J.engine_prune("topn_det", jnp.asarray(v), mode=mode,
                          shards=shards, N=N, w=W, obs="off")
    got = T.engine_prune("topn_det", torch.from_numpy(v), mode=mode,
                         shards=shards, N=N, w=W)
    _eq(got.keep, want.keep)
    if mode == "two_pass" and shards > 1:
        _eq(got.state.threshold, want.state.threshold)
        st = convert.topn_det_state_from_numpy(
            threshold=np.asarray(want.state.threshold), device="cpu")
        assert torch.equal(st.threshold, got.state.threshold)
    else:
        _state_eq(got.state, want.state)


@pytest.mark.parametrize("kind", ["pos", "neg", "const"])
def test_topn_det_merge_and_apply_match_jax(kind):
    v = _values(kind, 999, seed=4)
    r = T.engine_prune("topn_det", torch.from_numpy(v), mode="sharded",
                       shards=4, N=N, w=W)
    jr = J.engine_prune("topn_det", jnp.asarray(v), mode="sharded",
                        shards=4, N=N, w=W, obs="off")
    st = convert.topn_det_state_from_numpy(
        *(np.asarray(getattr(jr.state, f))
          for f in ("t0", "counts", "seen", "cur_level")), device="cpu")
    merged = T.merge_states("topn_det", st, N=N, w=W)
    jmerged = J.merge_states("topn_det", jr.state, N=N, w=W)
    _eq(merged.threshold, jmerged.threshold)
    lanes = T.shard_stack(torch.from_numpy(v), 4, float(NEG))
    keep = T.apply_merged("topn_det", merged, (lanes,), r.keep, N=N, w=W)
    jkeep = J.apply_merged("topn_det", jmerged,
                           (J.shard_stack(jnp.asarray(v), 4, NEG),),
                           jr.keep, N=N, w=W)
    _eq(keep, jkeep)


def test_topn_det_pass1_lanes_match_per_lane_scans():
    # S lanes of the pass-1 kernel's plain version are S independent scans
    v = torch.from_numpy(_values("pos", 3 * 300, seed=9))
    keep, (t0, counts, seen, cur) = tds.topn_det_pass1_kernel(v, N=N, w=W,
                                                              shards=3)
    for s in range(3):
        one = T.topn_det_prune(v[s * 300:(s + 1) * 300], N=N, w=W)
        assert torch.equal(keep[s * 300:(s + 1) * 300], one.keep)
        assert torch.equal(counts[s], one.state.counts)
        assert int(seen[s]) == 300 and int(cur[s]) == int(one.state.cur_level)
        assert torch.equal(t0[s], one.state.t0)


def test_topn_det_init_and_bad_arguments():
    st = T.topn_det_init(W, device="cpu")
    j = topn_det_init(W)
    _state_eq(st, j)
    # a resumed fresh state is the one-shot scan
    x = torch.tensor([3.0, 1.0, 4.0, 1.0])
    _state_eq(T.topn_det_prune(x, N=2, state=st).state,
              J.topn_det_prune(jnp.asarray(x.numpy()), N=2, w=W,
                               state=j).state)
    with pytest.raises(ValueError, match="levels"):
        T.topn_det_prune(torch.zeros(4), N=2, w=0)
    with pytest.raises(ValueError, match="multiple"):
        tds.topn_det_pass1_kernel(torch.zeros(5), N=2, w=2, shards=2)


# ---------------------------------------------------------------- LRU
D = 16


def _fingerprints(m, universe, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, universe, m).astype(np.uint32)


@pytest.mark.parametrize("universe", [20, 60, 400])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_distinct_lru_matches_jax(universe, w):
    f = _fingerprints(1200, universe, seed=universe + w)
    got = T.distinct_prune(torch.from_numpy(f), d=D, w=w, seed=5)
    want = J.distinct_prune(jnp.asarray(f), d=D, w=w, seed=5)  # lru default
    _eq(got.keep, want.keep)
    for fld in ("slots", "valid", "head"):
        _eq(getattr(got.state, fld), getattr(want.state, fld))


def test_distinct_lru_hits_at_every_slot():
    # one row (d = 1): values 0..w-1 fill it, then each is hit at slot w-1
    # (the least recent), and a hit at every slot in turn
    w = 4
    f = np.array([0, 1, 2, 3, 0, 1, 2, 3, 3, 2, 2, 0, 9, 1, 9, 9],
                 np.uint32)
    got = T.distinct_prune(torch.from_numpy(f), d=1, w=w)
    want = J.distinct_prune(jnp.asarray(f), d=1, w=w)
    _eq(got.keep, want.keep)
    _eq(got.state.slots, want.state.slots)
    # the plain version alone: 0 is hit at slot w-1 and moves to the front
    keep, (slots, valid, _) = tref.distinct_lru_ref(
        torch.tensor([0, 1, 2, 3, 0], dtype=torch.int32).view(torch.uint32),
        d=1, w=w, return_state=True)
    assert keep.tolist() == [True] * 4 + [False]
    assert slots.view(torch.int32).tolist() == [[0, 3, 2, 1]]
    assert valid.all()


@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("m", [1000, 1003])
def test_engine_distinct_lru_matches_jax(mode, shards, m):
    f = _fingerprints(m, 300, seed=m + shards)
    p = dict(d=D, w=4, seed=3)  # policy="lru": the default on both sides
    want = J.engine_prune("distinct", jnp.asarray(f), mode=mode,
                          shards=shards, obs="off", **p)
    got = T.engine_prune("distinct", torch.from_numpy(f), mode=mode,
                         shards=shards, **p)
    _eq(got.keep, want.keep)
    fields = (("slots", "valid", "shard") if mode == "two_pass"
              and shards > 1 else ("slots", "valid", "head"))
    for fld in fields:
        _eq(getattr(got.state, fld), getattr(want.state, fld))


def test_lru_pass1_takes_block_one_only():
    f = torch.zeros(512, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="block=1"):
        tpar.distinct_shard_states_kernel(f, d=8, w=2, shards=2, block=16,
                                          policy="lru")
    with pytest.raises(ValueError, match="policy"):
        tpar.distinct_shard_states_kernel(f, d=8, w=2, shards=2, block=1,
                                          policy="random")
    with pytest.raises(ValueError, match="policy"):
        T.engine_prune("distinct", f, d=8, w=2, policy="lfu")
