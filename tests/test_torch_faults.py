"""Nine places where the port gave another answer than the JAX package.

Each test feeds the same numpy input to both packages on the CPU, on the
smallest input that shows the departure, and holds the port to the
reference, faults of the reference included:

- A1: an int32 column under a dictionary or RLE encoding pads with NEG,
  which numpy converts to -2^31 (TOP-N det and rand, SKYLINE);
- A2: the engine hands every kernel entry the dtype it takes (f32 for
  TOP-N, uint32 or f32 for DISTINCT), whatever the column's dtype;
- A3: DISTINCT on a float32 column hashes the value's bits, stores the
  uint32 conversion of the value and compares the slot with the value in
  f32, so 4.0 hits the slot 4.5 filled and a repeated 4.5 never hits;
- A4: SKYLINE's one-entry pass inserts a NaN score, as the engine's scan
  does, and its block pass spends a round on it without inserting, as
  ``ref.skyline_block_ref`` does; an APH score of +inf is NaN;
- A5: the GROUP BY MIN/MAX master folds with Python's ``min``/``max``,
  emissions first and then the state, so a NaN after a finite partial is
  dropped and a NaN first wins;
- A6: the HAVING SUM master sums int64 values without wrapping;
- A8: TOP-N's block candidate is XLA's scatter max, which takes +0 over
  -0 in either order (``scatter_reduce("amax")`` keeps the first);
- A9: that candidate is NaN when any entry of the (row, block) group is
  NaN, whatever its sign, so the row takes no insert (the card's block
  kernel ordered a negative NaN below every finite value; the CPU tests
  hold its plain version, which the card checks it against);
- A10: RLE TOP-N's sums (seen, the level counts, N - seen, N - C) are
  int32 and wrap past 2^31, so runs after the wrap count as warm again
  (the port's plain version summed in int64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rle_scan as jrle
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import core as T
from repro_torch.core.hashing import hash_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parallel as tpar
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rle_scan as trle
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt

NAN, INF = float("nan"), float("inf")


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _tables(cols, encode=None):
    jtab = jt.Table("t", {k: jnp.asarray(v) for k, v in cols.items()})
    ttab = tt.Table.from_numpy("t", cols, device="cpu")
    if encode:
        jtab = jtab.encode(*encode[1], rle=encode[0] == "rle")
        ttab = ttab.encode(*encode[1], rle=encode[0] == "rle")
    return jtab, ttab


def _queries(spec, cols, encode=None):
    jtab, ttab = _tables(cols, encode)
    a = jq.run_query(jq.QuerySpec(*spec), jtab, obs="off")
    b = tq.run_query(tq.QuerySpec(*spec), ttab)
    _eq(b["keep"], a["keep"])
    return a["output"], b["output"]


# ------------------------------------------------------------------- A1
@pytest.mark.parametrize("kind", ["dict", "rle"])
@pytest.mark.parametrize("spec", [
    ("topn", ("duration",), dict(mode="det", N=1, w=4)),
    ("topn", ("duration",), dict(mode="rand", N=1, d=4, w=2)),
    ("skyline", ("duration", "revenue"), dict(w=2)),
], ids=["topn_det", "topn_rand", "skyline"])
def test_a1_int32_dictionary_pads_with_saturated_neg(spec, kind):
    cols = {"duration": np.array([3, 5, 2], np.int32),
            "revenue": np.array([1.0, 0.5, 4.0], np.float32)}
    want, got = _queries(spec, cols, (kind, spec[1]))
    if spec[0] == "topn":
        _eq(got[0], want[0])
        _eq(got[1], want[1])
        assert got[0].tolist() == [5.0] and got[1].tolist() == [1]
    else:
        _eq(got, want)


def test_a1_with_pad_converts_as_numpy():
    enc = T.DictEncoding(lut=torch.tensor([3, 5], dtype=torch.int32))
    neg = np.float32(-3.4e38)
    assert enc.with_pad(neg).lut.tolist() == [3, 5, -(1 << 31)]
    assert enc.with_pad(neg).lut.tolist()[-1] == int(
        jnp.asarray(neg, jnp.int32))
    u = T.DictEncoding(lut=torch.tensor([7], dtype=torch.int32).view(
        torch.uint32))
    assert u.with_pad(0).lut.view(torch.int32).tolist() == [7, 0]


# ------------------------------------------------------------------- A2
def _record(monkeypatch):
    seen = []
    for name in ("topn_shard_states_kernel", "topn_apply_kernel",
                 "distinct_shard_states_kernel", "distinct_apply_kernel"):
        fn = getattr(tpar, name)

        def spy(values, *a, _fn=fn, _name=name, **kw):
            seen.append((_name, values.dtype))
            return _fn(values, *a, **kw)
        monkeypatch.setattr(tpar, name, spy)
    return seen


@pytest.mark.parametrize("mode", ["scan", "two_pass"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8,
                                   np.float64])
def test_a2_topn_rand_hands_the_kernels_f32(monkeypatch, mode, dtype):
    x = np.random.default_rng(2).integers(0, 200, 301).astype(dtype)
    want = J.engine_prune("topn_rand", jnp.asarray(x), mode=mode, shards=4,
                          d=16, w=4, obs="off")
    seen = _record(monkeypatch)
    got = T.engine_prune("topn_rand", torch.from_numpy(x), mode=mode,
                         shards=4, d=16, w=4)
    _eq(got.keep, want.keep)
    assert seen and all(dt == torch.float32 for _, dt in seen)


@pytest.mark.parametrize("mode", ["scan", "two_pass"])
@pytest.mark.parametrize("dtype,form", [
    (np.uint32, torch.uint32), (np.int32, torch.uint32),
    (np.int16, torch.uint32), (np.float32, torch.float32)])
def test_a2_distinct_hands_the_kernels_their_form(monkeypatch, mode, dtype,
                                                  form):
    x = (np.random.default_rng(3).integers(-40, 40, 401) / 2).astype(dtype)
    want = J.engine_prune("distinct", jnp.asarray(x), mode=mode, shards=4,
                          d=8, w=2, obs="off")
    seen = _record(monkeypatch)
    got = T.engine_prune("distinct", torch.from_numpy(x), mode=mode,
                         shards=4, d=8, w=2)
    _eq(got.keep, want.keep)
    assert seen and all(dt == form for _, dt in seen)


def test_a2_distinct_form():
    x = torch.tensor([-1, 5], dtype=torch.int32)
    assert tpar.distinct_form(x).view(torch.int32).tolist() == [-1, 5]
    assert tpar.distinct_form(x.to(torch.int64)).dtype == torch.uint32
    assert tpar.distinct_form(x.double()).dtype == torch.float32


# ------------------------------------------------------------------- A3
def test_a3_smallest_float_input():
    """ROADMAP's input: 4.0 lands in the row of 4.5, whose slot holds 4."""
    x = np.array([4.5, 4.0], np.float32)
    want = J.distinct_prune(jnp.asarray(x), d=4, w=2)
    got = T.distinct_prune(torch.from_numpy(x), d=4, w=2)
    assert got.keep.tolist() == [True, False]
    _eq(got.keep, want.keep)
    _eq(got.state.slots, want.state.slots)
    a, b = _queries(("distinct", ("v",), dict(d=4, w=2)), {"v": x})
    _eq(b, a)
    assert b.tolist() == [4.5]


SPECIAL = np.array([-3.0, -0.0, 0.0, 4.5, NAN, INF, -INF, 2.0 ** 32, 5e9,
                    2.0 ** 31, 4294967040.0, 1e-30, 0.999, 4.0, 7.0, -7.0,
                    16777217.0, 3.5, 2.0 ** 32, 0.0], np.float32)


def _special(dtype, m, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return np.concatenate([rng.choice(SPECIAL, m),
                               rng.integers(0, 6, m).astype(np.float32)])
    if dtype == np.int32:
        return rng.integers(-6, 6, 2 * m).astype(np.int32)
    return rng.choice(np.array([0, 1, 2, 2 ** 31, 2 ** 32 - 1, 5],
                               np.uint32), 2 * m)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("d,w", [(2, 2), (3, 4), (8, 1)])
def test_a3_distinct_conversions_match_reference(dtype, policy, d, w):
    x = _special(dtype, 150, seed=d * 10 + w)
    want = J.distinct_prune(jnp.asarray(x), d=d, w=w, policy=policy)
    got = T.distinct_prune(torch.from_numpy(x), d=d, w=w, policy=policy)
    _eq(got.keep, want.keep)
    for f in ("slots", "valid", "head"):
        _eq(getattr(got.state, f), getattr(want.state, f))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("mode", ["sharded", "two_pass"])
def test_a3_engine_and_master_match_reference(dtype, mode):
    x = _special(dtype, 200, seed=5)
    want = J.engine_prune("distinct", jnp.asarray(x), mode=mode, shards=4,
                          d=4, w=2, obs="off")
    got = T.engine_prune("distinct", torch.from_numpy(x), mode=mode,
                         shards=4, d=4, w=2)
    _eq(got.keep, want.keep)
    _eq(T.master_complete_distinct(torch.from_numpy(x), got.keep),
        J.master_complete_distinct(jnp.asarray(x), want.keep))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_a3_run_query_distinct_matches_reference(dtype):
    x = _special(dtype, 100, seed=11)
    a, b = _queries(("distinct", ("v",), dict(d=4, w=2)), {"v": x})
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ------------------------------------------------------------------- A4
@pytest.mark.parametrize("pts,score,keep", [
    ([[NAN, 4.0], [3.0, 2.0], [2.0, 1.0]], "sum", [True, True, False]),
    ([[5.0, INF], [3.0, 2.0]], "aph", [True, True]),
])
def test_a4_skyline_scan_inserts_nan_scores(pts, score, keep):
    x = np.array(pts, np.float32)
    want = J.skyline_prune(jnp.asarray(x), w=1, score=score)
    got = T.skyline_prune(torch.from_numpy(x), w=1, score=score)
    assert got.keep.tolist() == keep
    _eq(got.keep, want.keep)
    _eq(got.state.scores, want.state.scores)
    _eq(got.state.points, want.state.points)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("score", ["sum", "aph"])
@pytest.mark.parametrize("block,w", [(1, 2), (1, 4), (8, 2), (32, 4)])
def test_a4_skyline_nan_and_inf_points_match_reference(seed, score, block, w):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 6, (256, 2)).astype(np.float32)
    x[rng.random((256, 2)) < 0.05] = NAN
    x[rng.random((256, 2)) < 0.05] = INF
    x[rng.random((256, 2)) < 0.03] = -INF
    if block == 1:
        want = J.skyline_prune(jnp.asarray(x), w=w, score=score)
        jkeep, jst = want.keep, (want.state.points, want.state.scores)
    else:
        jkeep, jst = jref.skyline_block_ref(jnp.asarray(x), w=w, block=block,
                                            score=score, return_state=True)
    keep, st = tref.skyline_block_ref(torch.from_numpy(x), w=w, block=block,
                                      score=score, return_state=True)
    _eq(keep, np.asarray(jkeep).astype(bool))
    _eq(st[0], jst[0])
    _eq(st[1], jst[1])


# ------------------------------------------------------------------- A5
@pytest.mark.parametrize("agg,vals,want", [
    ("max", [2.0, 1.0, NAN], {5: 2.0, 6: 1.0}),
    ("max", [NAN, 1.0, 2.0], None),
    ("min", [2.0, 1.0, NAN], {5: 2.0, 6: 1.0}),
    ("min", [-0.0, 1.0, 0.0], {5: -0.0, 6: 1.0}),
])
def test_a5_groupby_min_max_master_folds_as_python(agg, vals, want):
    keys = np.array([5, 6, 5], np.uint32)
    v = np.array(vals, np.float32)
    a = J.groupby_prune(jnp.asarray(keys), jnp.asarray(v), d=1, w=1, agg=agg)
    b = T.groupby_prune(torch.from_numpy(keys), torch.from_numpy(v), d=1,
                        w=1, agg=agg)
    ja = J.master_complete_groupby(a, agg)
    tb = T.master_complete_groupby(b, agg)
    assert sorted(tb) == sorted(ja)
    for k in ja:
        assert (np.isnan(tb[k]) and np.isnan(ja[k])) or (
            tb[k] == ja[k] and np.signbit(tb[k]) == np.signbit(ja[k])), k
    if want is not None:
        assert tb == want


@pytest.mark.parametrize("agg", ["min", "max"])
@pytest.mark.parametrize("mode", ["scan", "two_pass"])
def test_a5_groupby_master_with_nan_partials(agg, mode):
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 12, 400).astype(np.uint32)
    v = rng.normal(size=400).astype(np.float32)
    v[rng.random(400) < 0.1] = NAN
    v[rng.random(400) < 0.05] = -0.0
    a = J.engine_prune("groupby", jnp.asarray(keys), jnp.asarray(v),
                       mode=mode, shards=4, d=2, w=2, agg=agg, obs="off")
    b = T.engine_prune("groupby", torch.from_numpy(keys), torch.from_numpy(v),
                       mode=mode, shards=4, d=2, w=2, agg=agg)
    ja = J.master_complete_groupby(a, agg)
    tb = T.master_complete_groupby(b, agg)
    assert sorted(tb) == sorted(ja)
    for k in ja:
        assert (np.isnan(tb[k]) and np.isnan(ja[k])) or (
            tb[k] == ja[k] and np.signbit(tb[k]) == np.signbit(ja[k])), k


# ------------------------------------------------------------------- A6
@pytest.mark.parametrize("vals,threshold", [
    ([INF, INF, 200.0], 100),
    ([INF, INF, 200.0], 100.5),
    ([9.2e18, 9.2e18, 1.0], 2 ** 64),
    ([9.2e18, 9.2e18, 1.0], 18400000000000000000),
    ([-9.2e18, -9.2e18, 3.0], -(2 ** 64)),
])
def test_a6_having_sum_master_does_not_wrap(vals, threshold):
    keys = np.array([5, 5, 5], np.uint32)
    v = np.array(vals, np.float32)
    keep = np.ones(3, bool)
    want = J.master_complete_having(keys, v, keep, threshold)
    got = T.master_complete_having(torch.from_numpy(keys),
                                   torch.from_numpy(v),
                                   torch.from_numpy(keep), threshold)
    assert got == [int(k) for k in want]
    if vals[0] == INF:
        assert got == []


# ------------------------------------------------------------- A8 and A9
NEG32 = np.float32(-3.4e38)
# x86's default NaN (sign bit set, as inf - inf gives it on the host), and
# the positive quiet NaN
NNAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
PNAN = np.array([0x7FC00000], np.uint32).view(np.float32)[0]
# values at, just below and just above NEG, and -inf
LOW = [NEG32, np.nextafter(NEG32, np.float32(-INF)),
       np.nextafter(NEG32, np.float32(0)), np.float32(-INF)]


def _topn_block_both(x, d, w, block, seed=0):
    """(keep, state) of the reference's block oracle, then of the port's
    plain version and of its pass-1 entry point on a CPU tensor."""
    jk, js = jref.topn_block_ref(jnp.asarray(x), d=d, w=w, block=block,
                                 seed=seed, return_state=True)
    t = torch.from_numpy(x)
    ours = [tref.topn_block_ref(t, d=d, w=w, block=block, seed=seed,
                                return_state=True),
            tpar.topn_shard_states_kernel(t, d=d, w=w, shards=1,
                                          block=block, seed=seed)]
    return (np.asarray(jk), np.asarray(js)), ours


def _f32_bits(a):
    """The bits of an f32 array, every NaN as one."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _topn_block_matches(x, d, w, block, seed=0):
    (jk, js), ours = _topn_block_both(x, d, w, block, seed)
    for keep, state in ours:
        np.testing.assert_array_equal(keep.numpy(), jk.astype(bool))
        np.testing.assert_array_equal(_f32_bits(state.reshape(d, w)),
                                      _f32_bits(js))
    return js


def _a8_stream(m, d, block, seed, rng):
    """Negatives and values at or below NEG, and in every block that holds
    two entries of one row, -0 then +0 at the first two of them: the tie
    is the row's best candidate, and the row's first one inserts."""
    x = rng.choice(np.array([-1.0, -2.5, *LOW], np.float32), m)
    rows = hash_mod(torch.arange(m), d, seed).numpy()
    for b in range(0, m, block):
        r = rows[b:b + block]
        first = {}
        for i, row in enumerate(r.tolist()):
            if row in first:
                x[b + first[row]], x[b + i] = -0.0, 0.0
                break
            first[row] = i
    return x.astype(np.float32)


def _a9_stream(m, rng):
    """NaNs of both signs beside finite values that beat the row minimum,
    +-inf, +-0 and values at or below NEG."""
    pool = np.array([NNAN, PNAN, 5.0, 1.0, 2.0, 3.0, -0.0, 0.0, INF, *LOW],
                    np.float32)
    x = rng.choice(pool, m).astype(np.float32)
    x[::3] = rng.random(x[::3].shape[0]).astype(np.float32) * 10
    return x


def test_a8_smallest_input():
    """[-0.0, 0.0], d = w = 1, B = 2: the reference stores +0
    (0x00000000); the port's plain version stored -0 (0x80000000)."""
    x = np.array([-0.0, 0.0], np.float32)
    js = _topn_block_matches(x, 1, 1, 2)
    assert _f32_bits(js).tolist() == [[0x00000000]]


@pytest.mark.parametrize("d", [1, 3, 37])
@pytest.mark.parametrize("block", [2, 8, 32])
@pytest.mark.parametrize("seed", range(3))
def test_a8_topn_block_max_takes_plus_zero(seed, block, d):
    x = _a8_stream(512, d, block, seed,
                   np.random.default_rng(seed * 100 + block + d))
    _topn_block_matches(x, d, 3, block, seed)


def test_a9_smallest_input():
    """A negative NaN beside 5.0, which beats the row's minimum: the
    reference's candidate is NaN and the row takes no insert; the card's
    block kernel took 5.0 ([5.0, 3.0] instead of [3.0, NEG])."""
    x = np.array([NNAN, 5.0, 1.0, 2.0, 3.0, 3.0, 3.0, 3.0], np.float32)
    js = _topn_block_matches(x, 1, 2, 4)
    assert np.asarray(js).tolist() == [[3.0, float(NEG32)]]


@pytest.mark.parametrize("d", [1, 3, 37])
@pytest.mark.parametrize("block", [2, 8, 32])
@pytest.mark.parametrize("seed", range(3))
def test_a9_topn_block_nan_of_either_sign_blocks_the_insert(seed, block, d):
    x = _a9_stream(512, np.random.default_rng(seed * 100 + block + d))
    _topn_block_matches(x, d, 3, block, seed)


# ------------------------------------------------------------------ A10
def _rle_matches(v, L, N, w, block=8):
    """(head, tstar) of the reference's scan and of its Pallas kernel (in
    interpret mode), against the port's plain version and its
    ``rle_topn_prune`` on CPU tensors, bit for bit."""
    jv, jL = jnp.asarray(v), jnp.asarray(L)
    want = [np.asarray(a) for a in jrle.rle_topn_det_ref(jv, jL, N=N, w=w)]
    pallas = jops.rle_topn_prune(jv, jL, N=N, w=w, block=block)
    tv, tL = torch.from_numpy(v), torch.from_numpy(L)
    for got in (pallas, trle.rle_topn_det_ref(tv, tL, N=N, w=w),
                tops.rle_topn_prune(tv, tL, N=N, w=w, block=block)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), b)
    return want


def _a10_runs(seed, crossings, delta, N):
    """Runs whose lengths sum past 2^31 ``crossings`` times before a target
    run, whose seen_start wraps to N + delta: short runs, then 4 runs near
    2^30 a crossing with two short runs after each, the last one cut so that
    the target lands where it should, the target and five short runs."""
    rng = np.random.default_rng(seed)
    L = list(rng.integers(1, 50, 5))
    for _ in range(4 * crossings):
        L += [(1 << 30) + int(rng.integers(-5000, 5000))]
        L += list(rng.integers(0, 50, 2))
    target = crossings * (1 << 32) + N + delta
    L[-3] += target - sum(int(x) for x in L)
    assert 0 <= L[-3] < (1 << 31)
    L += list(rng.integers(1, 50, 6))
    v = (rng.random(len(L)) * 120 - 20).astype(np.float32)
    return v, np.array(L, np.int32)


def test_a10_smallest_input():
    """Three runs of 2^30 take seen past 2^31: the reference's int32 seen
    wraps negative, so the runs after them are warm again (head [.., 7, 3],
    tstar 1); the port summed in int64 (head [.., 0, 0])."""
    v = np.array([5, 4, 3, 9, 1], np.float32)
    L = np.array([1 << 30] * 3 + [7, 3], np.int32)
    head, tstar = _rle_matches(v, L, 100, 4)
    assert head.tolist() == [100, 0, 0, 7, 3]
    assert tstar.tolist() == [1, 1 << 30, 1, 1, 1]


@pytest.mark.parametrize("w", [1, 4, 8])
@pytest.mark.parametrize("N", [1, 100, 5000])
@pytest.mark.parametrize("delta", [-1, 1], ids=["below_N", "above_N"])
@pytest.mark.parametrize("crossings", [1, 2])
@pytest.mark.parametrize("seed", range(2))
def test_a10_rle_lengths_wrap_as_int32(seed, crossings, delta, N, w):
    v, L = _a10_runs(seed * 10 + crossings, crossings, delta, N)
    _rle_matches(v, L, N, w)
