"""The port's engine and master completion against the JAX package's.

Same numpy-seeded streams through ``repro.core.engine_prune`` and
``repro_torch.core.engine_prune`` on the CPU: keep masks and states must be
bit-identical in every ported mode, for even and ragged m.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro_torch import convert
from repro_torch import core as T

D, W = 64, 4
PARAMS = {"topn_rand": dict(d=D, w=W, seed=3),
          "distinct": dict(d=D, w=W, policy="fifo", seed=3),
          "distinct_lru": dict(d=D, w=W, seed=3)}   # policy="lru": default


def _algo(name):
    return "distinct" if name.startswith("distinct") else name


def _stream(algo, m, seed=0):
    rng = np.random.default_rng(seed)
    if algo == "topn_rand":
        return rng.gamma(2.0, 50.0, m).astype(np.float32)
    return rng.integers(0, 400, m).astype(np.uint32)


def _jax(algo, x, **kw):
    return J.engine_prune(algo, jnp.asarray(x), obs="off", **kw)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", ["topn_rand", "distinct", "distinct_lru"])
@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("m", [2048, 2051])
def test_engine_matches_jax(name, mode, m):
    algo = _algo(name)
    x = _stream(algo, m, seed=m)
    p = PARAMS[name]
    want = _jax(algo, x, mode=mode, shards=8, **p)
    got = T.engine_prune(algo, torch.from_numpy(x), mode=mode, shards=8, **p)
    _eq(got.keep, want.keep)
    if algo == "topn_rand":
        _eq(got.state.vals, want.state.vals)
    elif mode == "two_pass":
        for f in ("slots", "valid", "shard"):
            _eq(getattr(got.state, f), getattr(want.state, f))
    else:
        for f in ("slots", "valid", "head"):
            _eq(getattr(got.state, f), getattr(want.state, f))


@pytest.mark.parametrize("name", ["topn_rand", "distinct", "distinct_lru"])
@pytest.mark.parametrize("shards", [None, 1, 3])
def test_engine_shard_counts(name, shards):
    algo = _algo(name)
    x = _stream(algo, 1001, seed=11)
    p = PARAMS[name]
    want = _jax(algo, x, mode="two_pass", shards=shards, **p)
    got = T.engine_prune(algo, torch.from_numpy(x), mode="two_pass",
                         shards=shards, **p)
    _eq(got.keep, want.keep)


@pytest.mark.parametrize("apply_block", [None, 7, 100, 4096])
def test_apply_block_is_exact(apply_block):
    x = _stream("distinct", 2051, seed=4)
    p = PARAMS["distinct"]
    want = _jax("distinct", x, mode="two_pass", shards=8,
                apply_block=apply_block, **p)
    got = T.engine_prune("distinct", torch.from_numpy(x), mode="two_pass",
                         shards=8, apply_block=apply_block, **p)
    plain = T.engine_prune("distinct", torch.from_numpy(x), mode="two_pass",
                           shards=8, **p)
    _eq(got.keep, want.keep)
    assert torch.equal(got.keep, plain.keep)
    # TOP-N's apply is positional: apply_block is accepted and changes nothing
    v = _stream("topn_rand", 2051, seed=4)
    a = T.engine_prune("topn_rand", torch.from_numpy(v), mode="two_pass",
                       shards=8, apply_block=apply_block, **PARAMS["topn_rand"])
    _eq(a.keep, _jax("topn_rand", v, mode="two_pass", shards=8,
                     **PARAMS["topn_rand"]).keep)


def test_merge_and_apply_merged_match_jax():
    x = _stream("distinct", 1024, seed=8)
    p = PARAMS["distinct"]
    r = T.engine_prune("distinct", torch.from_numpy(x), mode="sharded",
                       shards=4, **p)
    jr = _jax("distinct", x, mode="sharded", shards=4, **p)
    merged = T.merge_states("distinct", r.state, **p)
    jmerged = J.merge_states("distinct", jr.state, **p)
    for f in ("slots", "valid", "shard"):
        _eq(getattr(merged, f), getattr(jmerged, f))
    lanes = T.shard_stack(torch.from_numpy(x), 4)
    keep = T.apply_merged("distinct", merged, (lanes,), r.keep.reshape(4, -1),
                          **p)
    jkeep = J.apply_merged("distinct", jmerged,
                           (J.shard_stack(jnp.asarray(x), 4),),
                           jr.keep.reshape(4, -1), **p)
    _eq(keep, jkeep)
    st = convert.distinct_state_from_numpy(
        np.asarray(jr.state.slots), np.asarray(jr.state.valid),
        np.asarray(jr.state.head), device="cpu")
    assert torch.equal(st.head, r.state.head)


@pytest.mark.parametrize("fill", [0.0, -1.5])
def test_shard_stack_matches_jax(fill):
    x = np.arange(10, dtype=np.float32)
    _eq(T.shard_stack(torch.from_numpy(x), 4, fill),
        J.shard_stack(jnp.asarray(x), 4, fill))
    u = np.arange(10, dtype=np.uint32) * np.uint32(400_000_000)
    got = T.shard_stack(torch.from_numpy(u), 3)
    assert got.dtype == torch.uint32
    _eq(got, J.shard_stack(jnp.asarray(u), 3))
    _eq(T.unshard_mask(got, 10), u)


def test_topn_and_distinct_scans_match_jax():
    v = _stream("topn_rand", 700, seed=2)
    a = T.topn_rand_prune(torch.from_numpy(v), d=D, w=W, seed=9)
    b = J.topn_rand_prune(jnp.asarray(v), d=D, w=W, seed=9)
    _eq(a.keep, b.keep)
    _eq(a.state.vals, b.state.vals)
    st = convert.topn_rand_state_from_numpy(np.asarray(b.state.vals),
                                            device="cpu")
    assert torch.equal(st.vals, a.state.vals)
    f = _stream("distinct", 700, seed=2)
    a = T.distinct_prune(torch.from_numpy(f), d=D, w=W, policy="fifo")
    b = J.distinct_prune(jnp.asarray(f), d=D, w=W, policy="fifo")
    _eq(a.keep, b.keep)
    _eq(a.state.slots, b.state.slots)
    _eq(a.state.head, b.state.head)


@pytest.mark.parametrize("N", [1, 5, 17, 64])
def test_master_complete_topn_ties(N):
    # few distinct values and the NEG fill of pruned entries: ties everywhere
    rng = np.random.default_rng(N)
    v = rng.integers(0, 6, 200).astype(np.float32)
    keep = rng.random(200) < 0.3
    tv, ti = T.master_complete_topn(torch.from_numpy(v), torch.from_numpy(keep),
                                    N)
    jv, ji = J.master_complete_topn(jnp.asarray(v), jnp.asarray(keep), N)
    _eq(tv, jv)
    _eq(ti, ji)


def test_master_complete_topn_fewer_survivors_than_n():
    v = np.array([3, 1, 2, 5], np.float32)
    keep = np.array([False, True, False, True])
    tv, ti = T.master_complete_topn(torch.from_numpy(v), torch.from_numpy(keep),
                                    4)
    jv, ji = J.master_complete_topn(jnp.asarray(v), jnp.asarray(keep), 4)
    _eq(tv, jv)
    _eq(ti, ji)


@pytest.mark.parametrize("seed", [0, 1])
def test_master_complete_distinct_and_oracles(seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 50, 300).astype(np.uint32)
    f[::7] = 0xFFFFFFFF
    keep = rng.random(300) < 0.6
    got = T.master_complete_distinct(torch.from_numpy(f),
                                     torch.from_numpy(keep))
    _eq(got, J.master_complete_distinct(jnp.asarray(f), jnp.asarray(keep)))
    _eq(T.opt_keep_distinct(f), J.opt_keep_distinct(f))
    v = rng.gamma(2.0, 5.0, 300).astype(np.float32)
    _eq(T.opt_keep_topn(v, 10), J.opt_keep_topn(v, 10))
    ok = T.opt_keep_topn(v, 10)
    assert T.prune_rate_vs_opt(torch.from_numpy(keep), ok) == \
        J.prune_rate_vs_opt(jnp.asarray(keep), jnp.asarray(ok.numpy()))
    moved, count = T.compact(torch.from_numpy(v), torch.from_numpy(keep))
    jmoved, jcount = J.compact(jnp.asarray(v), jnp.asarray(keep))
    _eq(moved, jmoved)
    assert int(count) == int(jcount)


def test_sizing_helpers_match():
    assert T.thm2_w(512, 100, 0.01) == J.thm2_w(512, 100, 0.01)
    assert T.thm2_opt_d(100, 0.01) == J.thm2_opt_d(100, 0.01)
    assert T.thm3_forwarded_bound(1 << 20, 512, 8) == \
        J.thm3_forwarded_bound(1 << 20, 512, 8)
    assert T.thm1_bound(1000, 64, 4) == J.thm1_bound(1000, 64, 4)


X = torch.zeros(64)
F = torch.zeros(64, dtype=torch.int32).view(torch.uint32)
CPU2 = T.Mesh(("cpu",) * 2)
# the resumes the engine refuses, and (since the mesh is ported) the mesh
# calls the reference's engine refuses too, each with its ValueError
NOT_PORTED = [
    ("topn_rand", X, dict(d=8, w=2, mode="mesh", pass2="sideways")),
    ("topn_rand", X, dict(d=8, w=2, pass2="mesh")),
    ("topn_rand", X, dict(d=8, w=2, mode="mesh", shards=3, mesh=CPU2)),
    ("topn_rand", X, dict(d=8, w=2, state=None)),
    ("topn_rand", X, dict(d=8, w=2, index_offset=3)),
    ("topn_rand", X, dict(d=8, w=2, mode="mesh", shards=65, mesh=CPU2)),
    ("topn_rand", X, dict(d=8, w=2, mode="mesh", shards="auto",
                          mesh=T.Mesh(("cpu",) * 65))),
    ("topn_rand", X, dict(d=8, w=2, options=T.ExecOptions(mode="mesh"),
                          shards=3, mesh=CPU2)),
    ("groupby", X, dict(d=8, w=2, state=None)),
    ("skyline", X[:, None], dict(w=2, state=None)),
    ("having", F, dict(threshold=1, state=None)),
]
MESH_REFUSALS = ("pass2 must be one of", "only applies to mode='mesh'",
                 "divisible", None, None, "exceeds stream length",
                 "shorter than the mesh", "divisible")


@pytest.mark.parametrize("algo,x,kw", NOT_PORTED)
def test_not_ported_raises(algo, x, kw):
    # a resume is refused as the reference's engine refuses it, pointing to
    # the stream and the core functions; a mesh call the reference refuses
    # raises its ValueError
    resume = "state" in kw or "index_offset" in kw
    if resume:
        with pytest.raises(NotImplementedError, match="PruneStream"):
            T.engine_prune(algo, x, **kw)
        return
    i = next(i for i, case in enumerate(NOT_PORTED) if case[2] is kw)
    with pytest.raises(ValueError, match=MESH_REFUSALS[i]):
        T.engine_prune(algo, x, **kw)


def test_resume_and_bad_arguments_raise():
    """The core functions resume as the reference's do (the engine refuses
    a resume as the reference's engine does, NOT_PORTED above)."""
    x = _stream("topn_rand", 64, seed=4)
    a = T.topn_rand_prune(torch.from_numpy(x), d=8, w=2, index_offset=5)
    b = J.topn_rand_prune(jnp.asarray(x), d=8, w=2, index_offset=5)
    _eq(a.keep, b.keep)
    _eq(a.state.vals, b.state.vals)
    u = _stream("distinct", 64, seed=4)
    st = T.distinct_prune(torch.from_numpy(u[:20]), d=8, w=2,
                          policy="fifo").state
    jst = J.distinct_prune(jnp.asarray(u[:20]), d=8, w=2,
                           policy="fifo").state
    a = T.distinct_prune(torch.from_numpy(u[20:]), d=8, w=2, policy="fifo",
                         state=st)
    b = J.distinct_prune(jnp.asarray(u[20:]), d=8, w=2, policy="fifo",
                         state=jst)
    _eq(a.keep, b.keep)
    for f in ("slots", "valid", "head"):
        _eq(getattr(a.state, f), getattr(b.state, f))
    with pytest.raises(KeyError):
        T.engine_prune("median", X)
    with pytest.raises(ValueError):
        T.engine_prune("topn_rand", X, d=8, w=2, mode="bogus")
    with pytest.raises(ValueError):
        T.engine_prune("topn_rand", X, d=8, w=2, mode="two_pass", shards=65)
