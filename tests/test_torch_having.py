"""The port's Count-Min sketch and HAVING against the JAX package's, on the
CPU.

Same numpy-seeded keys and values through both packages. The JAX kernels
run as the JAX package's own tests run them: Pallas in interpret mode, and
the jnp oracle (``use_ref=True``). Tables, estimates and masks are
bit-identical unless a test states otherwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core import having as jhaving
from repro.kernels import cms_sketch as jcms
from repro.kernels import ops as jops
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import convert
from repro_torch import core as T
from repro_torch.kernels import cms_sketch as tcms
from repro_torch.kernels import ops as tops
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt


def _keys(m, seed=0, universe=300):
    rng = np.random.default_rng(seed)
    k = (rng.zipf(1.3, m) % universe).astype(np.uint32)
    k[::97] = np.uint32(0xFFFFFFFF)
    return k


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------- kernels
@pytest.mark.parametrize("block", [16, 256])
@pytest.mark.parametrize("rows,width", [(2, 64), (3, 1024), (4, 4096)])
def test_cms_build_and_query_match_pallas_and_ref(block, rows, width):
    """Integer-valued f32 weights whose sums stay below 2^24: every order
    of adds gives the same table, so it is bit-identical."""
    m = 3001
    k = _keys(m, seed=rows)
    wts = np.random.default_rng(1).integers(0, 9, m).astype(np.float32)
    got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(wts),
                         rows=rows, width=width, block=block, seed=5)
    est = tops.cms_query(got, torch.from_numpy(k), block=block, seed=5)
    assert got.dtype == torch.float32 and est.dtype == torch.float32
    for use_ref in (False, True):
        want = jops.cms_build(jnp.asarray(k), jnp.asarray(wts), rows=rows,
                              width=width, block=block, seed=5,
                              use_ref=use_ref)
        _eq(got, want)
        _eq(est, jops.cms_query(want, jnp.asarray(k), block=block, seed=5,
                                use_ref=use_ref))


def test_cms_non_integer_weights_within_bound():
    """Non-integer f32 weights: the Pallas kernel sums each block first,
    the port's plain version adds entry by entry (and the CUDA kernel in
    atomics order), so the tables differ in rounding. Bound: each counter
    within 16 f32 ulps of its magnitude (relative 2^-19), far above the
    ~1e-7 relative error of a few thousand adds of values of one sign."""
    m = 4096
    k = _keys(m, seed=3)
    wts = np.random.default_rng(2).uniform(0, 10, m).astype(np.float32)
    got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(wts), rows=3,
                         width=256).numpy()
    for use_ref in (False, True):
        want = np.asarray(jops.cms_build(jnp.asarray(k), jnp.asarray(wts),
                                         rows=3, width=256,
                                         use_ref=use_ref))
        np.testing.assert_allclose(got, want, rtol=2.0 ** -19, atol=0)


def test_cms_kernel_level_entry_points():
    k = _keys(1024, seed=4)
    wts = np.ones(1024, np.float32)
    want = jcms.cms_build_kernel(jnp.asarray(k), jnp.asarray(wts), rows=3,
                                 width=512, block=256)
    got = tcms.cms_build_kernel(torch.from_numpy(k), torch.from_numpy(wts),
                                rows=3, width=512)
    assert got.shape == (1, 3, 512)
    _eq(got[0], want)
    _eq(tcms.cms_query_kernel(got[0], torch.from_numpy(k)),
        jcms.cms_query_kernel(want, jnp.asarray(k), block=256))


def test_cms_checks():
    k = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="2\\^16"):
        tops.cms_build(k, torch.ones(8), rows=3, width=1 << 16)
    with pytest.raises(ValueError, match="family"):
        tcms.cms_build_kernel(k, None, rows=3, width=8, family="crc")
    with pytest.raises(ValueError, match="weights"):
        tcms.cms_build_kernel(k, torch.ones(8, dtype=torch.float64), rows=3,
                              width=8)
    with pytest.raises(ValueError, match="shards"):
        tcms.cms_build_kernel(k, None, rows=3, width=8, shards=3)


# --------------------------------------------------------- engine sketch
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("width", [1000, 70_000])
def test_engine_sketch_matches_jax(dtype, width):
    """The engine's family (multi_hash, modulo on both sides of 2^16) and
    a table of the weights' dtype; integer-valued weights."""
    k = _keys(2000, seed=width % 7)
    v = np.random.default_rng(0).integers(1, 1000, 2000).astype(dtype)
    for wts in (None, v):
        want = J.cms_build(jnp.asarray(k), None if wts is None
                           else jnp.asarray(wts), 3, width, seed=9)
        got = T.cms_build(torch.from_numpy(k), None if wts is None
                          else torch.from_numpy(wts), 3, width, seed=9)
        assert got.table.dtype == (torch.int32 if wts is None
                                   else torch.from_numpy(v).dtype)
        _eq(got.table, want.table)
        _eq(T.cms_query(got, torch.from_numpy(k)),
            J.cms_query(want, jnp.asarray(k)))
        thr = 500
        _eq(T.cms_query(got, torch.from_numpy(k), thr),
            J.cms_query(want, jnp.asarray(k)) > thr)


# ---------------------------------------------------------------- engine
def _stream(m, seed):
    rng = np.random.default_rng(seed)
    return _keys(m, seed), rng.integers(1, 1000, m).astype(np.int32)


@pytest.mark.parametrize("agg,threshold", [("count", 20), ("sum", 9000)])
@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("shards", [1, 4, 8])
@pytest.mark.parametrize("m", [2048, 2051])
def test_engine_having_matches_jax(agg, threshold, mode, shards, m):
    """Ragged m pads the last shard with (keys[0], 0): under COUNT each pad
    adds 1 to keys[0]'s counters, in the reference too."""
    k, v = _stream(m, seed=m + shards)
    p = dict(threshold=threshold, rows=3, width=512, agg=agg, seed=2)
    want = J.engine_prune("having", jnp.asarray(k), jnp.asarray(v),
                          mode=mode, shards=shards, obs="off", **p)
    got = T.engine_prune("having", torch.from_numpy(k), torch.from_numpy(v),
                         mode=mode, shards=shards, **p)
    _eq(got.keep, want.keep)
    assert got.state.table.dtype == torch.int32
    _eq(got.state.table, want.state.table)
    assert got.state.seed == want.state.seed


def test_engine_having_int32_wrap_matches_reference():
    """The reference's int32 Count-Min SUM wraps past 2^31 - 1 (its table
    takes the values' dtype), and a key whose estimate wraps negative is
    pruned although its true sum passes the threshold. The port reproduces
    the reference bit for bit and does not widen the table."""
    k = np.array([7, 7, 7, 3, 7, 3], np.uint32)
    v = np.array([1 << 30] * 3 + [5, 1 << 30, 6], np.int32)
    for mode in ("scan", "two_pass"):
        want = J.engine_prune("having", jnp.asarray(k), jnp.asarray(v),
                              mode=mode, shards=2, threshold=10, rows=2,
                              width=64, obs="off")
        got = T.engine_prune("having", torch.from_numpy(k),
                             torch.from_numpy(v), mode=mode, shards=2,
                             threshold=10, rows=2, width=64)
        _eq(got.keep, want.keep)
        _eq(got.state.table, want.state.table)
        # key 7's sum, 2^32, wraps to 0: its rows are pruned
        assert not got.keep[0]
    assert T.having_oracle(torch.from_numpy(k), torch.from_numpy(v), 10) \
        == J.having_oracle(k, v, 10) == [3, 7]


def test_merge_and_apply_merged_having():
    k, v = _stream(1000, seed=5)
    p = dict(threshold=8000, width=256)
    r = T.engine_prune("having", torch.from_numpy(k), torch.from_numpy(v),
                       mode="sharded", shards=4, **p)
    jr = J.engine_prune("having", jnp.asarray(k), jnp.asarray(v),
                        mode="sharded", shards=4, obs="off", **p)
    _eq(r.state.table, jr.state.table)
    lanes = (T.shard_stack(torch.from_numpy(k), 4),
             T.shard_stack(torch.from_numpy(v), 4))
    jlanes = (J.shard_stack(jnp.asarray(k), 4),
              J.shard_stack(jnp.asarray(v), 4))
    jkeep = J.apply_merged("having", jr.state, jlanes, None, **p)
    _eq(T.apply_merged("having", r.state, lanes, None, **p), jkeep)
    # a JAX sketch carried into the port gives the same pass-2 mask
    cm = convert.count_min_from_numpy(np.asarray(jr.state.table),
                                      seed=jr.state.seed, device="cpu")
    _eq(T.apply_merged("having", cm, lanes, None, **p), jkeep)


def test_init_and_scan_match():
    for dtype, jdtype in ((torch.int32, jnp.int32),
                          (torch.float32, jnp.float32)):
        cm = T.having_init(rows=2, width=16, seed=3, dtype=dtype,
                           device="cpu")
        jcm = jhaving.having_init(rows=2, width=16, seed=3, dtype=jdtype)
        _eq(cm.table, jcm.table)
        assert cm.seed == jcm.seed
    k, v = _stream(700, seed=2)
    a = T.having_prune(torch.from_numpy(k), torch.from_numpy(v), 9000,
                       width=128)
    b = J.having_prune(jnp.asarray(k), jnp.asarray(v), 9000, width=128)
    _eq(a.keep, b.keep)
    _eq(a.state.table, b.state.table)
    # resumed on the carried sketch: keep against the running estimate
    ra = T.having_prune(torch.from_numpy(k), torch.from_numpy(v), 9000,
                        width=128, state=a.state)
    rb = J.having_prune(jnp.asarray(k), jnp.asarray(v), 9000, width=128,
                        state=b.state)
    _eq(ra.keep, rb.keep)
    _eq(ra.state.table, rb.state.table)


def test_having_stream_checks():
    k = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="stream"):
        T.engine_prune("having", k, k, k, threshold=1)
    with pytest.raises(ValueError, match="unequal"):
        T.engine_prune("having", k, torch.zeros(7, dtype=torch.int32),
                       threshold=1)
    with pytest.raises(ValueError, match="stream"):
        T.engine_prune("skyline", torch.zeros(8, 2), torch.zeros(8, 2), w=2)


# ------------------------------------------------------ master and query
@pytest.mark.parametrize("agg,threshold", [("count", 5), ("sum", 2000),
                                           ("sum", 2000.5)])
def test_master_complete_having_matches(agg, threshold):
    k, v = _stream(500, seed=1)
    keep = np.random.default_rng(3).random(500) < 0.7
    got = T.master_complete_having(torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(keep), threshold, agg)
    assert got == J.master_complete_having(k, v, keep, threshold, agg)
    assert T.having_oracle(torch.from_numpy(k), torch.from_numpy(v),
                           threshold, agg) == \
        J.having_oracle(k, v, threshold, agg)


@pytest.mark.parametrize("kind", [
    (("source_ip", "duration"), dict(threshold=30, agg="count", width=256)),
    (("lang", "duration"), dict(threshold=24000, rows=3, width=64)),
    (("source_ip", "ad_revenue"), dict(threshold=1500.0, seed=4)),
])
def test_run_query_having_matches_jax(kind):
    cols, params = kind
    jtab = jt.make_uservisits(3001, seed=1)
    ttab = tt.make_uservisits(3001, seed=1, device="cpu")
    a = jq.run_query(jq.QuerySpec("having", cols, params), jtab, obs="off")
    b = tq.run_query(tq.QuerySpec("having", cols, params), ttab)
    np.testing.assert_array_equal(b["keep"].numpy(), np.asarray(a["keep"]))
    assert b["output"] == a["output"]
    for key in ("forwarded", "total"):
        assert a[key] == b[key]
