"""Places where the port gave another answer than the JAX package.

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
  (the port's plain version summed in int64);
- A18: JOIN's master joins no NaN key (the reference matches keys by ==);
- A11: the Pallas Bloom and Count-Min kernels hash an int32 key in signed
  int32 arithmetic (every shift arithmetic), which fills only the lower
  half of a width below 2^16 and drops a probe of -1;
- A13: 64-bit columns are narrowed as ``jnp.asarray`` narrows them, the
  HAVING table takes the values' dtype and wraps in it, GROUP BY takes
  keys of any integer, bool or float dtype, and a float16 stream pads with
  -inf;
- A14: GROUP BY on float keys stores the key converted to uint32 and hits
  on the float compare, as DISTINCT does (A3);
- A19: TOP-N's master orders as ``lax.top_k``: -0 below +0, a NaN with its
  sign set below -inf;
- A12: the dictionary's entry for the zeros and for NaN is np.unique's;
- A15: SKYLINE stacks uint32 with int32 as int32;
- A16: FILTER compares with a weakly typed Python literal, which wraps into
  the column's dtype and raises OverflowError outside int32;
- A17: ``ops.rle_distinct_prune`` converts float run values to uint32 by
  value;
- A20: a float16 HAVING table adds in f16 in entry order, as the
  reference's scatter-add does (3000 unit weights on one key read 2048;
  the card's build had added in f32 and rounded once);
- A25: XLA flushes f32 subnormals to a zero of their sign in every add,
  minimum, maximum and compare, and keeps them in copies, selects, gathers
  and a sort's payload; its minimum takes -0 below +0 and its maximum +0
  above -0, and it simplifies ``0.0 + v`` to ``v``;
- A26: the Pallas TOP-N apply reads a row minimum by a one-hot product, so
  a non-finite minimum spoils the other rows' reads (B15); the engine's
  two_pass reads the minimum itself;
- A27: the Pallas TOP-N pass 1 reads the row minimum by the same product,
  so once one row's minimum is +inf only that row keeps (its +inf entries)
  and once two rows' are nothing keeps; a block holding +inf and NaN in
  one row inserts nothing (its candidate is NaN);
- A28: XLA's f32 scatter-add adds in entry order and flushes after each
  add, so a counter whose weights take both signs can pass below FLT_MIN
  and flush on the way ([1.5, -1, 1] * FLT_MIN reads FLT_MIN), and a sum
  flushed to -0 reads +0 in the table;
- A29: XLA's CPU reduction sums f32 values in windows of 32, each in order
  from +0, then the window sums (the HAVING merge over S lanes, the Pallas
  Count-Min build's block sums), every add flushed; a jitted Count-Min
  build keeps the -0 of rows 0 and 1 and reads rows 2 and up as +0;
- A30: a Pallas Count-Min block of 32 keys or fewer is one fused loop of
  XLA's CPU code, which LLVM vectorises from a block that depends on the
  row and the width (``cms_sketch.short_block_order``): keys by lanes of 8
  (or 4 lanes unrolled 4 times), a halving tree, the rest in order;
- A31: DISTINCT's pass 2 on a mesh position's lanes (the serial and the
  batched apply) ranks a lane by its global index and reads w columns a
  lane of the union, as the reference's ``_lane_ids`` do (the port took
  local lane s for lane s, and the union's width over the local lanes
  for w).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core import sketches as jsk
from repro.kernels import cms_sketch as jcms
from repro.kernels import ops as jops
from repro.kernels import parallel as jpar
from repro.kernels import ref as jref
from repro.kernels import rle_scan as jrle
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import core as T
from repro_torch.core.hashing import hash_mod
from repro_torch.kernels import cms_sketch as tcms
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
    plain version and of its pass-1 entry point on a CPU tensor, in the
    family that reads the row minimum itself, as the oracle does (the
    kernels' family reads it by the Pallas one-hot product: A27)."""
    jk, js = jref.topn_block_ref(jnp.asarray(x), d=d, w=w, block=block,
                                 seed=seed, return_state=True)
    t = torch.from_numpy(x)
    ours = [tref.topn_block_ref(t, d=d, w=w, block=block, seed=seed,
                                return_state=True),
            tpar.topn_shard_states_kernel(t, d=d, w=w, shards=1,
                                          block=block, seed=seed,
                                          family="engine")]
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


# ------------------------------------------------------------------ A18
def _join(a, b, nbits=64):
    spec = ("join", ("k", "k"), dict(nbits=nbits))
    fa, fb = np.array(a, np.float32), np.array(b, np.float32)
    want = jq.run_query(jq.QuerySpec(*spec),
                        (jt.Table("a", {"k": jnp.asarray(fa)}),
                         jt.Table("b", {"k": jnp.asarray(fb)})), obs="off")
    got = tq.run_query(tq.QuerySpec(*spec),
                       (tt.Table.from_numpy("a", {"k": fa}, device="cpu"),
                        tt.Table.from_numpy("b", {"k": fb}, device="cpu")))
    _eq(got["keep"], want["keep"])
    return list(zip(*(c.tolist() for c in got["output"]))), want["output"]


@pytest.mark.parametrize("a,b,rows", [
    ([1.0, NAN], [1.0, NAN], [(1.0, 1.0, 1.0)]),
    ([1.0, 2.0, NAN], [2.0, 1.0, NAN], [(1.0, 1.0, 1.0), (2.0, 2.0, 2.0)]),
])
def test_a18_smallest_inputs(a, b, rows):
    got, want = _join(a, b)
    assert got == want == rows


@pytest.mark.parametrize("seed", range(4))
def test_a18_join_with_nan_keys_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pool = np.array([0.0, -0.0, 1.0, 2.5, -3.0, NAN, NNAN, INF], np.float32)
    got, want = _join(rng.choice(pool, 23), rng.choice(pool, 17), nbits=256)
    assert got == want


# ------------------------------------------------------------------ A11
def test_a11_smallest_bloom_input():
    k = np.array([0], np.int32)
    want = np.asarray(jops.bloom_build(jnp.asarray(k), nbits=64, block=1))
    got = tops.bloom_build(torch.from_numpy(k), nbits=64, block=1)
    assert torch.nonzero(got).flatten().tolist() == [0, 25, 29]
    _eq(got, want)


def test_a11_smallest_cms_input():
    k = np.arange(4096, dtype=np.int32)
    w = np.ones(4096, np.float32)
    want = jops.cms_build(jnp.asarray(k), jnp.asarray(w), rows=3, width=4096)
    got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(w), rows=3,
                         width=4096)
    _eq(got, want)
    # the reference fills only the lower half of the width
    assert not bool(got[:, 2048:].any())


def _signed_keys(m, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2 ** 31), 2 ** 31, m).astype(np.int32)


@pytest.mark.parametrize("nbits", [64, 4096, 1 << 24])
@pytest.mark.parametrize("seed", range(2))
def test_a11_bloom_query_int32_keys(nbits, seed):
    rng = np.random.default_rng(seed)
    k = _signed_keys(512, seed)
    bits = (rng.random(nbits) < 0.5).astype(np.float32)
    want = jops.bloom_query(jnp.asarray(bits), jnp.asarray(k),
                            use_ref=nbits >= (1 << 16))
    got = tops.bloom_query(torch.from_numpy(bits), torch.from_numpy(k))
    _eq(got, want)


@pytest.mark.parametrize("width", [64, 4096, 1 << 24])
@pytest.mark.parametrize("seed", range(2))
def test_a11_cms_query_int32_keys(width, seed):
    rng = np.random.default_rng(seed)
    k = _signed_keys(512, seed)
    table = rng.integers(0, 9, (3, width)).astype(np.float32)
    want = jops.cms_query(jnp.asarray(table), jnp.asarray(k),
                          use_ref=width >= (1 << 16))
    got = tops.cms_query(torch.from_numpy(table), torch.from_numpy(k))
    _eq(got, want)


@pytest.mark.parametrize("width", [64, 4096])
@pytest.mark.parametrize("seed", range(2))
def test_a11_cms_plain_int32_keys_match_pallas(width, seed):
    """The plain build and query of the kernels' family, int32 keys of both
    signs, against the JAX Count-Min kernels in interpret mode."""
    k = _signed_keys(1024, seed)
    w = np.random.default_rng(seed).integers(0, 5, 1024).astype(np.float32)
    want = jcms.cms_build_kernel(jnp.asarray(k), jnp.asarray(w), rows=3,
                                 width=width, block=256)
    got = tcms.cms_build_plain(torch.from_numpy(k), torch.from_numpy(w),
                               rows=3, width=width)[0]
    _eq(got, want)
    _eq(tcms.cms_query_plain(got, torch.from_numpy(k)),
        jcms.cms_query_kernel(want, jnp.asarray(k), block=256))
    _eq(tops.bloom_build(torch.from_numpy(k), nbits=width),
        jops.bloom_build(jnp.asarray(k), nbits=width))


def test_a11_probe_of_minus_one_is_dropped():
    """At widths of 2^15 or more the signed multiply-shift gives -1 for some
    keys (these three at width 40000, seed 0): the Pallas kernels' one-hot
    matches no column, so the build adds nothing and the query reads 0."""
    bad = np.array([-2040099539, -2010473350, -2006560011], np.int32)
    k = np.concatenate([bad, _signed_keys(253, 5)]).astype(np.int32)
    w = np.ones(256, np.float32)
    want = jops.cms_build(jnp.asarray(k), jnp.asarray(w), rows=1,
                          width=40000)
    got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(w), rows=1,
                         width=40000)
    _eq(got, want)
    assert float(got.sum()) == 253.0
    _eq(tops.cms_query(got, torch.from_numpy(k)),
        jops.cms_query(want, jnp.asarray(k)))
    bits = np.ones(40000, np.float32)
    q = tops.bloom_query(torch.from_numpy(bits), torch.from_numpy(bad),
                         num_hashes=1)
    assert q.tolist() == [False] * 3
    _eq(q, jops.bloom_query(jnp.asarray(bits), jnp.asarray(bad),
                            num_hashes=1))


# ------------------------------------------------------------------ A13
def test_a13_having_sum_over_uint32_values():
    cols = {"k": np.array([5, 5, 6], np.uint32),
            "v": np.array([1, 2, 3], np.uint32)}
    a, b = _queries(("having", ("k", "v"),
                     dict(threshold=2, rows=1, width=4, agg="sum")), cols)
    assert b == [int(x) for x in a] == [5, 6]


def test_a13_groupby_over_int64_keys():
    k = np.array([5, 5, 6], np.int64)
    v = np.array([1, 2, 3], np.float32)
    want = J.master_complete_groupby(J.engine_prune(
        "groupby", jnp.asarray(k), jnp.asarray(v), d=1, w=2, obs="off"))
    got = T.master_complete_groupby(T.engine_prune(
        "groupby", torch.from_numpy(k), torch.from_numpy(v), d=1, w=2))
    assert got == want == {5: 3.0, 6: 3.0}


def test_a13_uservisits_having_sum_of_lang():
    spec = ("having", ("source_ip", "lang"),
            dict(threshold=300, width=64, agg="sum"))
    want = jq.run_query(jq.QuerySpec(*spec), jt.make_uservisits(1000),
                        obs="off")
    got = tq.run_query(tq.QuerySpec(*spec),
                       tt.make_uservisits(1000, device="cpu"))
    _eq(got["keep"], want["keep"])
    assert got["forwarded"] == want["forwarded"] == 750
    assert got["output"] == [int(x) for x in want["output"]]


def test_a13_float16_topn_det_pads_with_minus_inf():
    x = np.arange(5).astype(np.float16)
    want = J.engine_prune("topn_det", jnp.asarray(x), mode="two_pass",
                          shards=4, N=1, w=1, obs="off")
    got = T.engine_prune("topn_det", torch.from_numpy(x), mode="two_pass",
                         shards=4, N=1, w=1)
    _eq(got.keep, want.keep)


NARROW = [np.int8, np.int16, np.int64, np.uint8, np.uint16, np.uint64,
          np.float16, np.float64]


@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("dtype", NARROW + [np.uint32])
def test_a13_having_sum_values_of_other_dtypes(dtype, mode):
    rng = np.random.default_rng(7)
    k = rng.integers(0, 6, 203).astype(np.uint32)
    v = rng.integers(0, 120, 203).astype(dtype)
    kw = dict(threshold=700, rows=2, width=8, agg="sum", mode=mode, shards=4)
    want = J.engine_prune("having", jnp.asarray(k), jnp.asarray(v),
                          obs="off", **kw)
    got = T.engine_prune("having", torch.from_numpy(k), torch.from_numpy(v),
                         **kw)
    _eq(got.keep, want.keep)
    table = np.asarray(want.state.table)
    assert got.state.table.dtype == torch.from_numpy(table).dtype
    _eq(got.state.table, table)


@pytest.mark.parametrize("dtype,vals,threshold", [
    (np.uint8, [200, 100, 3], 250),
    (np.int8, [100, 100, 3], 300),
    (np.int8, [100, 100, 3], 2.5),
    (np.uint32, [2 ** 31 + 5, 2 ** 31, 3], -1),
])
def test_a13_having_table_wraps_in_the_values_dtype(dtype, vals, threshold):
    k = np.array([5, 5, 6], np.uint32)
    v = np.array(vals, dtype)
    kw = dict(threshold=threshold, rows=1, width=4, agg="sum")
    want = J.engine_prune("having", jnp.asarray(k), jnp.asarray(v),
                          obs="off", **kw)
    got = T.engine_prune("having", torch.from_numpy(k), torch.from_numpy(v),
                         **kw)
    _eq(got.keep, want.keep)
    _eq(got.state.table, want.state.table)


@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("dtype", NARROW + [np.bool_])
def test_a13_groupby_keys_of_other_dtypes(dtype, mode):
    rng = np.random.default_rng(11)
    raw = rng.integers(-9, 9, 157)
    k = (raw > 0) if dtype == np.bool_ else (raw / 2).astype(dtype) \
        if np.dtype(dtype).kind == "f" else raw.astype(dtype)
    v = rng.integers(0, 50, 157).astype(np.float32)
    kw = dict(d=3, w=2, agg="sum", mode=mode, shards=4)
    want = J.engine_prune("groupby", jnp.asarray(k), jnp.asarray(v),
                          obs="off", **kw)
    got = T.engine_prune("groupby", torch.from_numpy(k), torch.from_numpy(v),
                         **kw)
    for g, w in zip(got.emitted, want.emitted):
        _eq(g, w)
    _eq(got.state.keys, want.state.keys)
    assert (T.master_complete_groupby(got, "sum")
            == J.master_complete_groupby(want, "sum"))


# ------------------------------------------------------------------ A14
def _groupby_both(keys, d=1, w=1, mode="scan", shards=2, agg="sum",
                  vals=None):
    k = np.array(keys, np.float32)
    v = np.ones(k.shape, np.float32) if vals is None else vals
    kw = dict(d=d, w=w, agg=agg, mode=mode, shards=shards)
    want = J.engine_prune("groupby", jnp.asarray(k), jnp.asarray(v),
                          obs="off", **kw)
    got = T.engine_prune("groupby", torch.from_numpy(k), torch.from_numpy(v),
                         **kw)
    for g, wv in zip(got.emitted, want.emitted):
        _eq(g, wv)
    _eq(got.state.keys, want.state.keys)
    return (T.master_complete_groupby(got, agg),
            J.master_complete_groupby(want, agg))


@pytest.mark.parametrize("keys,answer", [
    ([7.5], {7: 1.0}),
    ([7.0, 7.5], {7: 2.0}),
    ([-0.0, 0.0], {0: 2.0}),
])
def test_a14_smallest_inputs(keys, answer):
    got, want = _groupby_both(keys)
    assert got == want == answer


@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("d,w", [(1, 2), (3, 2), (4, 40)])
@pytest.mark.parametrize("seed", range(2))
def test_a14_groupby_float_keys_match_reference(seed, d, w, mode):
    rng = np.random.default_rng(seed)
    keys = rng.choice(SPECIAL, 211)
    vals = rng.integers(0, 9, 211).astype(np.float32)
    got, want = _groupby_both(keys, d=d, w=w, mode=mode, shards=4,
                              vals=vals)
    assert got == want


# ------------------------------------------------------------------ A19
@pytest.mark.parametrize("vals,row", [([-0.0, 0.0], 1), ([NNAN, 1.0], 1)])
def test_a19_smallest_inputs(vals, row):
    x = np.array(vals, np.float32)
    keep = np.ones(2, bool)
    wv, wi = J.master_complete_topn(jnp.asarray(x), jnp.asarray(keep), 1)
    gv, gi = T.master_complete_topn(torch.from_numpy(x),
                                    torch.from_numpy(keep), 1)
    assert gi.tolist() == np.asarray(wi).tolist() == [row]
    assert _bits(gv.numpy()) == _bits(wv)


@pytest.mark.parametrize("N", [1, 5, 17])
@pytest.mark.parametrize("seed", range(3))
def test_a19_topn_master_orders_as_top_k(seed, N):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([SPECIAL, [NNAN, PNAN, -INF, NEG32]]).astype(
        np.float32)
    x = rng.choice(pool, 41)
    keep = rng.random(41) < 0.8
    wv, wi = J.master_complete_topn(jnp.asarray(x), jnp.asarray(keep), N)
    gv, gi = T.master_complete_topn(torch.from_numpy(x),
                                    torch.from_numpy(keep), N)
    _eq(gi, wi)
    assert _bits(gv.numpy()) == _bits(wv)


# ------------------------------------------------------------------ A12
def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32).tolist()


def test_a12_dictionary_is_np_unique():
    x = np.array([1, 1, 0.0, -0.0], np.float32)
    _, enc = T.dict_encode(torch.from_numpy(x))
    _, jenc = J.dict_encode(x)
    assert _bits(enc.lut) == _bits(np.unique(x)) == _bits(jenc.lut)
    a, b = _queries(("topn", ("v",), dict(mode="det", N=4)), {"v": x},
                    encode=("dict", ("v",)))
    assert _bits(b[0]) == _bits(a[0])
    a, b = _queries(("distinct", ("v",), dict(d=4, w=2)), {"v": x},
                    encode=("dict", ("v",)))
    assert _bits(b) == _bits(a) == _bits(np.unique(x))


def test_a12_dict_distinct_lru_keep():
    x = np.array([3.0, 5.0, -0.0, 0.0, 3.0], np.float32)
    _queries(("distinct", ("v",), dict(d=3, w=1)), {"v": x},
             encode=("dict", ("v",)))


@pytest.mark.parametrize("seed", range(4))
def test_a12_nan_patterns_and_zeros(seed):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np.array([0x7FC00000, 0xFFC00001, 0x7FC00123],
                                    np.uint32).view(np.float32),
                           [0.0, -0.0, 1.0, 2.0]]).astype(np.float32)
    x = rng.choice(pool, 29)
    _, enc = T.dict_encode(torch.from_numpy(x))
    assert _bits(enc.lut) == _bits(np.unique(x))
    a, b = _queries(("distinct", ("v",), dict(d=8, w=4)), {"v": x})
    assert _bits(b) == _bits(a)


# ------------------------------------------------------------------ A15
def test_a15_skyline_stacks_uint32_with_int32_as_int32():
    cols = {"a": np.array([2 ** 31, 5], np.uint32),
            "b": np.array([1, 2], np.int32)}
    a, b = _queries(("skyline", ("a", "b"), dict(w=4, score="sum")), cols)
    assert b.tolist() == np.asarray(a).tolist() == [False, True]


# ------------------------------------------------------------------ A16
U32_COL = np.array([0, 5, 2 ** 31, 2 ** 32 - 1, 16777217], np.uint32)


@pytest.mark.parametrize("op,rows", [("gt", []), ("eq", [3])])
def test_a16_smallest_inputs(op, rows):
    pred = (op, -1)
    want = J.Pred("c", *pred).evaluate({"c": jnp.asarray(U32_COL)})
    got = T.Pred("c", *pred).evaluate({"c": torch.from_numpy(U32_COL)})
    _eq(got, want)
    assert torch.nonzero(got).flatten().tolist() == rows


LITERALS = [-1, 0, 5, 2 ** 31 - 1, -(2 ** 31), 300, -129, 256, 1.5, -1.5,
            1e10, True, 16777217]


@pytest.mark.parametrize("op", ["gt", "ge", "lt", "le", "eq", "ne"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32, np.uint8,
                                   np.int8, np.int16, np.float16])
def test_a16_weakly_typed_literals(dtype, op):
    col = np.array([0, 5, 2 ** 31, 2 ** 32 - 1, 16777217, 300, 44, 255,
                    127, 1], np.int64).astype(dtype)
    if np.dtype(dtype).kind == "f":
        col[:3] = np.array([-1.5, 1.5, -0.0], dtype)
    for lit in LITERALS:
        want = J.Pred("c", op, lit).evaluate({"c": jnp.asarray(col)})
        got = T.Pred("c", op, lit).evaluate({"c": torch.from_numpy(col)})
        _eq(got, want)


@pytest.mark.parametrize("lit", [2 ** 31, -(2 ** 31) - 1, 2 ** 32 - 1])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_a16_int_outside_int32_raises(dtype, lit):
    col = np.array([1, 2], dtype)
    with pytest.raises(OverflowError):
        J.Pred("c", "gt", lit).evaluate({"c": jnp.asarray(col)})
    with pytest.raises(OverflowError):
        T.Pred("c", "gt", lit).evaluate({"c": torch.from_numpy(col)})


# ------------------------------------------------------------------ A17
@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_a17_smallest_input(policy):
    rv = np.array([1.0, 1.5], np.float32)
    want = jops.rle_distinct_prune(jnp.asarray(rv), d=1, w=2, policy=policy)
    got = tops.rle_distinct_prune(torch.from_numpy(rv), d=1, w=2,
                                  policy=policy)
    assert got.tolist() == np.asarray(want).tolist() == [True, False]


@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("seed", range(3))
def test_a17_float_run_values_convert_by_value(seed, policy):
    rv = np.random.default_rng(seed).choice(SPECIAL, 97)
    want = jops.rle_distinct_prune(jnp.asarray(rv), d=4, w=2, policy=policy)
    got = tops.rle_distinct_prune(torch.from_numpy(rv), d=4, w=2,
                                  policy=policy)
    _eq(got, want)


# ------------------------------------------------------------------ A20
def _f16_sums(seed, m=4000, keys=5):
    """Keys of a small universe and f16 weights of both signs whose sums
    pass 2^11, where an f16 add in entry order parts from an f32 sum."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, m).astype(np.uint32)
    w = (rng.random(m) * 24 - 6).astype(np.float16)
    return k, w


def test_a20_smallest_input():
    k = np.full(3000, 7, np.uint32)
    w = np.ones(3000, np.float16)
    want = np.asarray(jsk.cms_build(jnp.asarray(k), jnp.asarray(w), 3,
                                    4096).table)
    got = T.cms_build(torch.from_numpy(k), torch.from_numpy(w), 3,
                      4096).table
    assert got.dtype == torch.float16
    _eq(got, want)
    assert float(got.max()) == float(want.max()) == 2048.0


@pytest.mark.parametrize("seed", range(3))
def test_a20_sums_past_2_11_in_entry_order(seed):
    k, w = _f16_sums(seed)
    want = np.asarray(jsk.cms_build(jnp.asarray(k), jnp.asarray(w), 2,
                                    8).table)
    got = T.cms_build(torch.from_numpy(k), torch.from_numpy(w), 2, 8).table
    assert np.abs(want.astype(np.float32)).max() > 2048
    _eq(got, want)


@pytest.mark.parametrize("mode", ["scan", "two_pass"])
@pytest.mark.parametrize("seed", range(2))
def test_a20_having_sum_over_float16_values(seed, mode):
    k, w = _f16_sums(seed, m=4003)
    kw = dict(threshold=5000.0, rows=2, width=8, agg="sum", mode=mode,
              shards=4)
    want = J.engine_prune("having", jnp.asarray(k), jnp.asarray(w),
                          obs="off", **kw)
    got = T.engine_prune("having", torch.from_numpy(k), torch.from_numpy(w),
                         **kw)
    _eq(got.keep, want.keep)
    table = np.asarray(want.state.table)
    assert got.state.table.dtype == torch.float16
    _eq(got.state.table, table)


def test_a20_ops_cms_build_over_float16_weights():
    # the kernels' entry point builds in f32, as the Pallas kernel does, so
    # integer weights of both signs sum past 2^11 exactly on both sides
    k, w = _f16_sums(3, m=2000)
    w = np.floor(w)
    want = jops.cms_build(jnp.asarray(k), jnp.asarray(w), rows=2, width=64)
    got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(w), rows=2,
                         width=64)
    assert got.dtype == torch.float32 and float(got.max()) > 2048
    _eq(got, want)


# ------------------------------------------------------------ A21 - A24
# The Pallas Count-Min and Bloom queries read a row by a one-hot product
# (``gather_rows``): a NaN anywhere in the row, or an infinity away from the
# key's column, reads NaN (0 * inf), -0 reads +0 and subnormals flush; the
# estimate is capped at its start value float32(3.4e38). The port's
# ``ops.cms_query`` and ``ops.bloom_query`` had read the counter itself.
def _cms_keys():
    return np.arange(300, dtype=np.uint32) * np.uint32(2654435761)


def _f32_same(t, j):
    a = t.numpy()
    b = np.asarray(j)
    assert a.shape == b.shape and a.dtype == b.dtype
    nan = np.float32("nan")
    np.testing.assert_array_equal(np.where(np.isnan(a), nan, a).view(np.int32),
                                  np.where(np.isnan(b), nan, b).view(np.int32))


@pytest.mark.parametrize("where, value", [((2, 5), NAN), ((0, 3), -INF)])
def test_a21_nonfinite_counter_reads_nan_across_its_row(where, value):
    table = np.ones((3, 64), np.float32)
    table[where] = value
    k = _cms_keys()
    want = jops.cms_query(jnp.asarray(table), jnp.asarray(k))
    got = tops.cms_query(torch.from_numpy(table), torch.from_numpy(k))
    # every key but those at the -inf's own column reads NaN
    assert np.isnan(np.asarray(want)).mean() > 0.9
    _f32_same(got, want)


def test_a21_minus_zero_reads_plus_zero():
    table = np.full((3, 64), -0.0, np.float32)
    k = _cms_keys()
    want = jops.cms_query(jnp.asarray(table), jnp.asarray(k))
    got = tops.cms_query(torch.from_numpy(table), torch.from_numpy(k))
    assert not np.signbit(np.asarray(want)).any()
    _f32_same(got, want)


def test_a21_inf_at_the_keys_column_is_read():
    # +inf only reaches the keys that hash to its column, and loses the
    # minimum to the other rows' 1.0; every other key reads NaN in row 0
    table = np.ones((3, 64), np.float32)
    table[0, 3] = INF
    k = _cms_keys()
    want = np.asarray(jops.cms_query(jnp.asarray(table), jnp.asarray(k)))
    got = tops.cms_query(torch.from_numpy(table), torch.from_numpy(k))
    assert (want == 1.0).any() and np.isnan(want).any()
    _f32_same(got, want)


def test_a22_estimate_capped_at_3_4e38():
    table = np.full((3, 64), np.finfo(np.float32).max, np.float32)
    k = _cms_keys()
    want = jops.cms_query(jnp.asarray(table), jnp.asarray(k))
    got = tops.cms_query(torch.from_numpy(table), torch.from_numpy(k))
    assert (np.asarray(want).view(np.int32) == 0x7F7FC99E).all()
    _f32_same(got, want)


def _bloom_case():
    rng = np.random.default_rng(23)
    k = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    bits = np.asarray(jops.bloom_build(jnp.asarray(k[:300]), nbits=4096))
    return k, bits


@pytest.mark.parametrize("value", [NAN, INF])
def test_a23_nonfinite_bit_reads_nan_elsewhere(value):
    k, bits = _bloom_case()
    bits = bits.copy()
    bits[17] = value
    want = np.asarray(jops.bloom_query(jnp.asarray(bits), jnp.asarray(k)))
    got = tops.bloom_query(torch.from_numpy(bits), torch.from_numpy(k))
    assert not want.any()
    _eq(got, want)


def test_a24_plain_minimum_takes_a_nan_from_any_row():
    # the card's minimum had skipped a NaN below row 0; the plain version,
    # which the card is held to, takes it as jnp.min does
    table = np.full((3, 16), 5.0, np.float32)
    table[1, :] = NAN
    k = _cms_keys()
    want = np.asarray(J.cms_query(jsk.CountMin(jnp.asarray(table)),
                                  jnp.asarray(k)))
    got = T.cms_query(T.CountMin(torch.from_numpy(table)), torch.from_numpy(k))
    assert np.isnan(want).all()
    _f32_same(got, want)
    keep = T.cms_query(T.CountMin(torch.from_numpy(table)),
                       torch.from_numpy(k), 1.0)
    assert not keep.any()


# ------------------------------------------------------------- A25 - A26
# XLA flushes an f32 subnormal to a zero of its sign in every add, minimum,
# maximum and compare, on the CPU as on a TPU, and keeps it in a copy, a
# select, a gather or a sort's payload (A25): the port's plain versions and
# kernels do the same. Keep masks and states are held bit for bit, every
# NaN as one.
SUB = 1e-40


def _leaves(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [leaf for e in x for leaf in _leaves(e)]
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x)
                for leaf in _leaves(getattr(x, f.name))]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def _tree_bits(a):
    if a.dtype.kind == "f":
        a = np.where(np.isnan(a), np.float32("nan"), a).astype(a.dtype)
        return a.view(np.int32 if a.itemsize == 4 else np.int16)
    return a


def _same_tree(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_array_equal(_tree_bits(a), _tree_bits(b))


def _salted():
    """[0, s, 0, s, -s, 0, s, 2s] * 8 with s = 1e-40."""
    return np.tile(np.array([0, 1, 0, 1, -1, 0, 1, 2], np.float32)
                   * np.float32(SUB), 8)


def _engine_case(algo, streams, **kw):
    def run():
        want = J.engine_prune(algo, *map(jnp.asarray, streams), **kw)
        got = T.engine_prune(algo, *map(torch.from_numpy, streams), **kw)
        _same_tree(got.keep, want.keep)
        if algo != "distinct" or kw.get("mode") != "two_pass":
            _same_tree(got.state, want.state)
        else:  # the merged union (the reference also carries owner ranks)
            _same_tree((got.state.slots, got.state.valid),
                       (want.state.slots, want.state.valid))
        _same_tree(got.emitted, want.emitted)
    return run


def _ops_case(name, *arrays, **kw):
    def run():
        want = getattr(jops, name)(*map(jnp.asarray, arrays), **kw)
        got = getattr(tops, name)(*map(torch.from_numpy, arrays), **kw)
        _same_tree(got, want)
    return run


def _call_case(jf, tf, *arrays):
    def run():
        _same_tree(tf(*map(torch.from_numpy, arrays)),
                   jf(*map(jnp.asarray, arrays)))
    return run


def _pair(v):
    return np.ascontiguousarray(np.stack([v, v[::-1]], 1))


def _gb_keys():
    return np.tile(np.array([1, 2, 3, 1], np.uint32), 16)


def _filter_case(op, literal=0.0):
    def run():
        x = np.array([SUB, -SUB, 0.0, -0.0, 1.0], np.float32)
        want = np.asarray(J.Pred("x", op, literal).evaluate(
            {"x": jnp.asarray(x)}))
        got = T.Pred("x", op, literal).evaluate({"x": torch.from_numpy(x)})
        _eq(got, want)
    return run


def _cms_case():
    want = jsk.cms_build(jnp.asarray(np.array([7], np.uint32)),
                         jnp.asarray(np.array([SUB], np.float32)),
                         rows=1, width=4)
    got = T.cms_build(torch.tensor([7], dtype=torch.uint32),
                      torch.tensor([SUB], dtype=torch.float32), rows=1,
                      width=4)
    assert np.asarray(got.table).view(np.int32).tolist() == [[0, 0, 0, 0]]
    _same_tree(got.table, want.table)


def _merge_case():
    s = np.array([[[0.0, -0.0]], [[SUB, 0.0]]], np.float32)
    _same_tree(tpar.merge_topn_states(torch.from_numpy(s), 2),
               jpar.merge_topn_states(jnp.asarray(s), 2))


def _rle_case():
    rv = np.array([SUB, 0.0, -SUB, 2.0, -0.0, SUB, 1.0, 0.0], np.float32)
    rl = np.array([2, 1, 3, 1, 2, 1, 4, 2], np.int32)
    _same_tree(tops.rle_topn_prune(torch.from_numpy(rv), torch.from_numpy(rl),
                                   N=2, w=2),
               jops.rle_topn_prune(jnp.asarray(rv), jnp.asarray(rl), N=2,
                                   w=2))


def _a25_cases():
    v = _salted()
    tp = dict(mode="two_pass", shards=2)
    yield "topn_rand_scan", _engine_case(
        "topn_rand", [np.array([0.0, -SUB], np.float32)], d=1, w=1,
        mode="scan")
    yield "topn_rand_two_pass", _engine_case(
        "topn_rand", [np.tile(np.array([0.0, -SUB], np.float32), 4)], d=1,
        w=1, **tp)
    yield "topn_det_scan", _engine_case(
        "topn_det", [np.array([SUB, 0.0, 0.0], np.float32)], N=1, w=1,
        mode="scan")
    yield "topn_det_two_pass", _engine_case(
        "topn_det", [np.tile(np.array([SUB, 0.0, 0.0], np.float32), 2)],
        N=1, w=1, **tp)
    for policy in ("lru", "fifo"):
        yield f"distinct_{policy}_scan", _engine_case(
            "distinct", [np.array([0.0, SUB], np.float32)], d=1, w=2,
            policy=policy, mode="scan")
    yield "distinct_two_pass", _engine_case(
        "distinct", [np.tile(np.array([0.0, SUB], np.float32), 4)], d=1,
        w=2, **tp)
    for mode in ("scan", "two_pass"):
        kw = tp if mode == "two_pass" else dict(mode=mode)
        yield f"skyline_sum_{mode}", _engine_case(
            "skyline", [_pair(v)], w=2, score="sum", **kw)
        yield f"groupby_sum_{mode}", _engine_case(
            "groupby", [_gb_keys(), v], d=2, w=1, **kw)
    yield "having_sum_f32_scan", _engine_case(
        "having", [_gb_keys(), v], threshold=0.0, mode="scan")
    yield "skyline_aph_scan", _engine_case(
        "skyline", [_pair(v)], w=2, score="aph", mode="scan")
    for agg in ("min", "max"):
        yield f"groupby_{agg}_scan", _engine_case(
            "groupby", [_gb_keys(), v], d=2, w=1, agg=agg, mode="scan")
    yield "score_sum", _call_case(J.score_sum, T.score_sum, _pair(v))
    yield "core_cms_build", _cms_case
    yield "merge_topn_states", _merge_case
    yield "ops_topn_prune", _ops_case("topn_prune", v * 8, d=4, w=2,
                                      block=8)
    yield "ops_topn_prune_parallel", _ops_case(
        "topn_prune_parallel", v * 8, d=4, w=2, shards=2, block=8)
    yield "ops_skyline_prune", _ops_case("skyline_prune", _pair(v * 8), w=2,
                                         block=8)
    yield "ops_skyline_prune_parallel", _ops_case(
        "skyline_prune_parallel", _pair(v * 8), w=2, shards=2, block=8)
    yield "ops_cms_build", _ops_case(
        "cms_build", np.arange(64, dtype=np.uint32) % 5, v * 8, rows=2,
        width=8)
    yield "ops_rle_topn_prune", _rle_case
    for op in ("gt", "ge", "lt", "le", "eq", "ne"):
        yield f"filter_{op}", _filter_case(op)
    # a literal that is not a Python number compares by value, flushed too
    yield "filter_ge_numpy_float32", _filter_case("ge", np.float32(SUB))


A25 = dict(_a25_cases())


@pytest.mark.parametrize("case", list(A25))
def test_a25_subnormals_flush_in_compute_and_stay_in_copies(case):
    A25[case]()


def test_f16_build_and_aph_score_need_no_flush():
    # an f16 subnormal is an f32 normal, so the f16 Count-Min build (adds
    # in f32, rounded to f16) has nothing to flush; APH scores below 1
    # are -16 whatever the coordinate
    k = np.tile(np.array([3, 9, 3], np.uint32), 20)
    w = np.tile(np.array([6e-8, -3e-6, 1e-5], np.float16), 20)
    want = jsk.cms_build(jnp.asarray(k), jnp.asarray(w), rows=2, width=8)
    got = T.cms_build(torch.from_numpy(k), torch.from_numpy(w), rows=2,
                      width=8)
    assert got.table.dtype == torch.float16
    _same_tree(got.table, want.table)
    p = _pair(_salted())
    _same_tree(T.score_aph(torch.from_numpy(p)), J.score_aph(jnp.asarray(p)))


# A26: the Pallas TOP-N apply reads the row minimum by a one-hot product
# (B15): a row reads NaN when another row's minimum is not finite or its
# own is NaN. ops.topn_prune_parallel reads so; the engine's two_pass reads
# the minimum itself, as its jnp body does.
def _normals(m, seed=0):
    return np.random.default_rng(seed).standard_normal(m).astype(np.float32)


def test_a26_ops_topn_prune_parallel_with_an_inf():
    x = _normals(256)
    x[3] = INF
    kw = dict(d=4, w=1, shards=2, block=8)
    want = np.asarray(jops.topn_prune_parallel(jnp.asarray(x), **kw))
    got = tops.topn_prune_parallel(torch.from_numpy(x), **kw)
    assert want.sum() == 1
    _eq(got, want)


def test_a26_topn_apply_kernel_with_a_nan_row_minimum():
    v = _normals(64)
    merged = np.stack([np.full(4, 9.0, np.float32),
                       np.array([NAN, 0.5, 0.1, -0.2], np.float32)], 1)
    want = np.asarray(jpar.topn_apply_kernel(jnp.asarray(v),
                                             jnp.asarray(merged), d=4,
                                             shards=2, block=8))
    got = tpar.topn_apply_kernel(torch.from_numpy(v),
                                 torch.from_numpy(merged), d=4, shards=2)
    assert not want.any()
    _eq(got, want)


@pytest.mark.parametrize("value", [INF, NAN, -INF])
def test_a26_engine_two_pass_reads_the_minimum_itself(value):
    x = _normals(64, seed=1)
    x[5] = value
    kw = dict(d=4, w=1, mode="two_pass", shards=2)
    want = J.engine_prune("topn_rand", jnp.asarray(x), **kw)
    got = T.engine_prune("topn_rand", torch.from_numpy(x), **kw)
    _eq(got.keep, want.keep)


# ------------------------------------------------------------------- A27
# The Pallas TOP-N pass 1 (topn_prune_kernel, topn_shard_states_kernel)
# reads an entry's row minimum as sum_k onehot[k] * rowmin[k]: after a
# row's minimum turns +inf, every other row reads NaN and keeps nothing,
# that row keeps only +inf, and after a second row's turns +inf no entry
# keeps. The port's plain block pass read the minimum itself.
def _rows(n, d, seed=0):
    return hash_mod(torch.arange(n), d, seed).numpy()


def test_a27_smallest_input():
    x = np.full(4, INF, np.float32)
    kw = dict(d=2, w=1, block=2)
    want = np.asarray(jops.topn_prune(jnp.asarray(x), **kw))
    got = tops.topn_prune(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(want, [True, True, True, False])
    _eq(got, want)


@pytest.mark.parametrize("shards", [1, 2])
def test_a27_shard_states_keep(shards):
    """One +inf in the first block of each lane fills its row (w = 1):
    every later block keeps nothing outside that row."""
    n, d, block = 64, 4, 8
    x = _normals(shards * n, seed=3)
    for s in range(shards):
        x[s * n + 2 + s] = INF
    kw = dict(d=d, w=1, shards=shards, block=block)
    jk, js = jpar.topn_shard_states_kernel(jnp.asarray(x), **kw)
    tk, ts = tpar.topn_shard_states_kernel(torch.from_numpy(x), **kw)
    jk = np.asarray(jk).astype(bool)
    direct = tref.topn_block_ref(torch.from_numpy(x).reshape(shards, n), d=d,
                                 w=1, block=block).reshape(-1).numpy()
    assert (jk != direct).any() and not jk.reshape(shards, n)[:, block:].any()
    _eq(tk, jk)
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))


@pytest.mark.parametrize("shards", [1, 2])
def test_a27_two_rows_reach_inf(shards):
    """Row r1's minimum turns +inf first (block 0), then a second row's
    (at entry i2's block): from block 1 on, only r1's +inf entry i1 keeps
    (i2, read before its own block's insert, reads NaN), and after i2's
    block nothing does."""
    n, d, w, block = 96, 4, 1, 8
    rows = _rows(n, d)
    blk = np.arange(n) // block
    r1 = rows[0]
    i1 = next(i for i in range(block, n) if rows[i] == r1)
    i2 = next(i for i in range((blk[i1] + 1) * block, n) if rows[i] != r1)
    x = _normals(shards * n, seed=4)
    for s in range(shards):
        x[s * n + np.array([0, i1, i2])] = INF
    kw = dict(d=d, w=w, shards=shards, block=block)
    jk, js = jpar.topn_shard_states_kernel(jnp.asarray(x), **kw)
    tk, ts = tpar.topn_shard_states_kernel(torch.from_numpy(x), **kw)
    jk = np.asarray(jk).astype(bool).reshape(shards, n)
    assert (np.asarray(js)[:, :, -1] == INF).sum(1).tolist() == [2] * shards
    assert jk[:, block:].sum() == shards
    assert jk[:, i1].all() and not jk[:, i2].any()
    assert not jk[:, (blk[i2] + 1) * block:].any()
    _eq(tk.reshape(shards, n), jk)
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    _eq(tops.topn_prune(torch.from_numpy(x[:n]), d=d, w=w, block=block),
        np.asarray(jops.topn_prune(jnp.asarray(x[:n]), d=d, w=w,
                                   block=block)))


def test_a27_inf_and_nan_in_one_block_row_insert_nothing():
    """A block holding +inf and a NaN in one row r0 has a NaN candidate, so
    r0 takes no insert; a later +inf fills row r1 (w = 1), after which only
    r1's +inf entries keep. A fix-up that counted +inf entries would count
    r0 too and keep nothing."""
    n, d, block = 64, 2, 8
    rows = _rows(n, d)
    r0 = rows[0]
    x = _normals(n, seed=5)
    hit = np.flatnonzero(rows[:block] == r0)
    x[hit[0]], x[hit[1]] = INF, NAN
    i1 = next(i for i in range(block, n) if rows[i] != r0)
    i2 = next(i for i in range((i1 // block + 1) * block, n)
              if rows[i] == rows[i1])
    x[i1] = x[i2] = INF
    kw = dict(d=d, w=1, block=block)
    want = np.asarray(jops.topn_prune(jnp.asarray(x), **kw))
    got = tops.topn_prune(torch.from_numpy(x), **kw)
    assert np.flatnonzero(want[(i1 // block + 1) * block:]).tolist() == \
        [i2 - (i1 // block + 1) * block]
    _eq(got, want)
    st = tpar.topn_shard_states_kernel(torch.from_numpy(x), shards=1, **kw)[1]
    assert torch.isinf(st[0, :, -1]).tolist() == [r == rows[i1]
                                                  for r in range(d)]


def test_a27_salted_streams():
    """Random streams salted with +inf and NaN, every shape of the kernels'
    family at once (S = 1 and 2, B = 1 and 8, w = 1 and 3)."""
    rng = np.random.default_rng(6)
    for shards, block, d, w in ((1, 8, 3, 1), (2, 8, 4, 3), (1, 1, 3, 1),
                                (2, 1, 2, 2)):
        for salt in (0.02, 0.2):
            x = rng.standard_normal(shards * 128).astype(np.float32)
            u = rng.random(x.size)
            x[u < salt] = INF
            x[(u >= salt) & (u < 1.3 * salt)] = NAN
            kw = dict(d=d, w=w, shards=shards, block=block)
            jk, js = jpar.topn_shard_states_kernel(jnp.asarray(x), **kw)
            tk, ts = tpar.topn_shard_states_kernel(torch.from_numpy(x), **kw)
            _eq(tk, np.asarray(jk).astype(bool))
            np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                          np.asarray(js).view(np.int32))


# ------------------------------------------------------------------- A28
FLT_MIN = np.float32(1.1754943508222875e-38)


def test_a28_smallest_input():
    k = np.array([7, 7, 7], np.uint32)
    w = np.array([1.5, -1.0, 1.0], np.float32) * FLT_MIN
    want = np.asarray(jsk.cms_build(jnp.asarray(k), jnp.asarray(w), 1,
                                    4).table)
    got = T.cms_build(torch.from_numpy(k), torch.from_numpy(w), 1, 4).table
    assert want[0].max() == FLT_MIN
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _a28_case(seed, m=4096):
    """Weights of both signs in units of FLT_MIN / 8, so that every sum is
    exact and only the flushes decide the counters."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, m).astype(np.uint32)
    w = (rng.choice(np.array([-2, -1.5, -1, -0.5, 0.5, 1, 1.5, 2],
                             np.float32), m) * FLT_MIN).astype(np.float32)
    w[rng.random(m) < 0.1] *= np.float32(3.25)
    return k, w


@pytest.mark.parametrize("seed", [1, 2])
def test_a28_salted_mixed_sign(seed):
    k, w = _a28_case(seed)
    want = np.asarray(jsk.cms_build(jnp.asarray(k), jnp.asarray(w), 3,
                                    64).table)
    got = T.cms_build(torch.from_numpy(k), torch.from_numpy(w), 3, 64).table
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    kw = dict(mode="scan", threshold=0.0, rows=3, width=64)
    jr = J.engine_prune("having", jnp.asarray(k), jnp.asarray(w), obs="off",
                        **kw)
    tr = T.engine_prune("having", torch.from_numpy(k), torch.from_numpy(w),
                        obs="off", **kw)
    _eq(tr.keep, jr.keep)
    # by its bits: the jitted build keeps the -0 of rows 0 and 1 (A29)
    np.testing.assert_array_equal(tr.state.table.numpy().view(np.int32),
                                  np.asarray(jr.state.table).view(np.int32))


# ------------------------------------------------------------------- A29
def _a29_weights(rng, m):
    """Weights +-k * FLT_MIN / 8, k in 8..39: every sum is exact, and only
    the order of the flushes decides the counters."""
    return ((rng.integers(8, 40, m) * rng.choice([-1, 1], m)).astype(
        np.float32) * (FLT_MIN / 8)).astype(np.float32)


def _eq_bits(t, j):
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  np.asarray(j).view(np.int32))


@pytest.mark.parametrize("shards", [2, 17, 33, 40, 64, 65, 128])
def test_a29_engine_having_merge(shards):
    """The HAVING merge of two_pass sums the S lane tables as XLA's
    reduction does (33 lanes: a first window of 17, then 16)."""
    rng = np.random.default_rng(0)
    m = 64 * shards
    k = rng.integers(0, 5000, m).astype(np.uint32)
    w = _a29_weights(rng, m)
    kw = dict(mode="two_pass", shards=shards, threshold=0.0, rows=3,
              width=1024, obs="off")
    jr = J.engine_prune("having", jnp.asarray(k), jnp.asarray(w), **kw)
    tr = T.engine_prune("having", torch.from_numpy(k), torch.from_numpy(w),
                        **kw)
    _eq_bits(tr.state.table, jr.state.table)
    _eq(tr.keep, jr.keep)


@pytest.mark.parametrize("sign", [1, -1, 0])
def test_a29_ops_cms_build_f32(sign):
    """``ops.cms_build`` on f32 weights sums each block of 256 keys in XLA's
    order before it adds the block: on weights of both signs near FLT_MIN
    (3 x 64, 4096 keys below 5000, seed 1: the entry order left 149 of 192
    counters apart), and on non-integer weights of one sign, whose sums
    round by their order."""
    rng = np.random.default_rng(1)
    k = rng.integers(0, 5000, 4096).astype(np.uint32)
    w = _a29_weights(rng, 4096)
    if sign:
        w = (np.abs(rng.standard_normal(4096)) * 10).astype(
            np.float32) * np.float32(sign)
    want = jops.cms_build(jnp.asarray(k), jnp.asarray(w), rows=3, width=64)
    got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(w), rows=3,
                         width=64)
    _eq_bits(got, want)


def test_a29_jitted_build_keeps_minus_zero_in_rows_0_and_1():
    """Every counter's sum flushes to -0 ([-1.5, 1] * FLT_MIN a key): the
    jitted engine and ``having_prune`` keep -0 in rows 0 and 1 and read +0
    from row 2 on; the eager ``core.cms_build`` reads +0 everywhere."""
    k = np.repeat(np.arange(32, dtype=np.uint32), 2)
    w = np.tile(np.array([-1.5, 1.0], np.float32), 32) * FLT_MIN
    for mode in ("scan", "sharded"):
        kw = dict(mode=mode, threshold=0.0, rows=5, width=64, obs="off")
        if mode == "sharded":
            kw["shards"] = 2
        jr = J.engine_prune("having", jnp.asarray(k), jnp.asarray(w), **kw)
        tr = T.engine_prune("having", torch.from_numpy(k),
                            torch.from_numpy(w), **kw)
        _eq_bits(tr.state.table, jr.state.table)
    jtab = J.having_prune(jnp.asarray(k), jnp.asarray(w), 0.0, rows=5,
                          width=64).state.table
    assert np.signbit(np.asarray(jtab)[:2]).any()
    _eq_bits(T.having_prune(torch.from_numpy(k), torch.from_numpy(w), 0.0,
                         rows=5, width=64).state.table, jtab)
    _eq_bits(T.cms_build(torch.from_numpy(k), torch.from_numpy(w), 5,
                      64).table,
          jsk.cms_build(jnp.asarray(k), jnp.asarray(w), 5, 64).table)


# ------------------------------------------------------------------- A30
_A30_BLOCKS = (9, 15, 16, 17, 20, 24, 31, 32)


def _a30_weights(kind, rng, m):
    """Both signs near FLT_MIN (the flushes decide the counters), or
    non-integer weights of one sign (the rounding decides them)."""
    if kind == "flt":
        return _a29_weights(rng, m)
    w = (np.abs(rng.standard_normal(m)) * 10).astype(np.float32)
    return w if kind == "pos" else -w


def _a30_build(k, w, **kw):
    want = jops.cms_build(jnp.asarray(k), jnp.asarray(w), **kw)
    got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(w), **kw)
    _eq_bits(got, want)


@pytest.mark.parametrize("kind", ["flt", "pos", "neg"])
@pytest.mark.parametrize("width", [7, 16])
def test_a30_ops_cms_build_short_blocks(width, kind):
    """``ops.cms_build`` on f32 weights at blocks of 32 keys or fewer, 2040
    keys below 5000, 2 rows, seed 1 (the probe's input): at width 16 row 0
    is vectorised from block 22 and row 1 from block 20, at width 7 from 15
    and 14; blocks 24 to 32 are 8 lanes and the rest of the keys in order,
    block 20 is 4 lanes unrolled 4 times with an epilogue of 2."""
    for block in _A30_BLOCKS:
        rng = np.random.default_rng(1)
        k = rng.integers(0, 5000, 2040).astype(np.uint32)
        _a30_build(k, _a30_weights(kind, rng, 2040), rows=2, width=width,
                   block=block)


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("width", [3, 64])
def test_a30_rows_and_widths(rows, width):
    """The first vectorised block by row and width: rows past 0 from 14
    (20 at a power-of-two width), row 0 from 15 (22), and none at a width
    of 1, on keys of few distinct values (many hits a block)."""
    rng = np.random.default_rng(rows * 10 + width)
    for block, wd in ((14, width), (15, width), (20, width), (22, width),
                      (32, width), (32, 1)):
        pool = rng.integers(0, 1 << 20, 5).astype(np.uint32)
        k = pool[rng.integers(0, 5, 1536)]
        _a30_build(k, _a30_weights("flt", rng, 1536), rows=rows,
                   width=wd, block=block)


@pytest.mark.parametrize("block", [20, 24, 31])
def test_a30_short_last_block(block):
    """A stream that is no multiple of the block: the ops entry point pads
    the last block with (key 0, weight 0.0), whose products are +0 in the
    fused loop's lanes."""
    rng = np.random.default_rng(block)
    k = rng.integers(0, 300, 1000 + block // 2).astype(np.uint32)
    w = (rng.standard_normal(k.shape[0]) * 10).astype(np.float32)
    _a30_build(k, w, rows=3, width=16, block=block)
    _a30_build(k, _a30_weights("flt", rng, k.shape[0]), rows=3, width=16,
               block=block)


@pytest.mark.parametrize("block", [100, 256])
def test_a30_long_blocks_still_match(block):
    """Blocks of more than 32 keys keep the windows of A29."""
    rng = np.random.default_rng(block)
    k = rng.integers(0, 5000, 4096).astype(np.uint32)
    for kind in ("flt", "pos"):
        _a30_build(k, _a30_weights(kind, rng, 4096), rows=2, width=16,
                   block=block)


def test_a30_short_block_order_rule():
    """The rule's table: sequential below the threshold, and every
    vectorised order a sum of all B products (on integers, exact)."""
    assert tcms.short_block_order(32, 1, 0) == (1, 1, 1)
    assert tcms.short_block_order(21, 16, 0) == (1, 1, 1)
    assert tcms.short_block_order(22, 16, 0) == (4, 4, 2)
    assert tcms.short_block_order(14, 7, 1) == (8, 1, 0)
    assert tcms.short_block_order(13, 7, 1) == (1, 1, 1)
    x = torch.arange(1, 33, dtype=torch.float32)[None]
    for B in range(1, 33):
        for r in (0, 1):
            s = tcms.short_block_sum(x[:, :B], tcms.short_block_order(
                B, 5, r))
            assert float(s) == B * (B + 1) / 2


# ------------------------------------------------------------------- A31
_A31_S, _A31_N = 16, 64
_A31_POS = (0, 6, 12, 14)   # first lanes of positions of 2 lanes


def _a31_bed(policy):
    """16 DISTINCT lanes of 64 entries where 777, the last entry of lane
    12, stays in its cache and occurs again in lanes 13 to 15: the sharded
    states, merged, and the lanes of both packages."""
    rng = np.random.default_rng(31)
    x = rng.integers(1, 120, _A31_S * _A31_N).astype(np.uint32)
    x[[13 * _A31_N - 1] + [lane * _A31_N + 3 for lane in (13, 14, 15)]] = 777
    p = dict(d=16, w=2, policy=policy)
    j = J.engine_prune("distinct", jnp.asarray(x), mode="sharded",
                       shards=_A31_S, **p)
    t = T.engine_prune("distinct", torch.from_numpy(x), mode="sharded",
                       shards=_A31_S, **p)
    jm, tm = J.merge_states("distinct", j.state, **p), \
        T.merge_states("distinct", t.state, **p)
    jl = jnp.asarray(x).reshape(_A31_S, -1)
    tl = torch.from_numpy(x).reshape(_A31_S, -1)
    return p, (jm, jl, j.keep.reshape(_A31_S, -1)), \
        (tm, tl, t.keep.reshape(_A31_S, -1))


@pytest.mark.parametrize("policy", ["fifo", "lru"])
@pytest.mark.parametrize("g0", _A31_POS)
def test_a31_distinct_apply_on_a_position(g0, policy):
    """A resident pass 2 applies the merged union to one position's lanes
    only; a lane's rank in "a lower-ranked shard owns it" is global (the
    reference's ``_lane_ids``, the port's ``_lane0``), and a lane's columns
    in the union are w, not the union's width over the local lanes."""
    p, (jm, jl, jk), (tm, tl, tk) = _a31_bed(policy)
    cut = slice(g0, g0 + 2)
    want = J.apply_merged("distinct", jm, (jl[cut],), jk[cut],
                          _lane_ids=jnp.arange(g0, g0 + 2, dtype=jnp.int32),
                          **p)
    got = T.apply_merged("distinct", tm, (tl[cut].contiguous(),),
                         tk[cut].contiguous(), _lane0=g0, **p)
    _eq(got, want)


@pytest.mark.parametrize("g0", _A31_POS)
def test_a31_batched_distinct_apply_on_a_position(g0):
    """The batched DISTINCT apply (a mesh wave's resident pass 2) on one
    position's lanes, against the reference's batched apply."""
    from repro.core import batched as jbatched
    from repro_torch.core import batched as tbatched

    p, (jm, jl, jk), (tm, tl, tk) = _a31_bed("fifo")
    cut = slice(g0, g0 + 2)
    jqp, jcaps = jbatched.BSPECS["distinct"].build([p])
    jq1 = {k: v[0] for k, v in jqp.items()}
    jq1["_lane_ids"] = jnp.arange(g0, g0 + 2, dtype=jnp.int32)
    want = jbatched.BSPECS["distinct"].apply(jm, (jl[cut],), jk[cut], jq1,
                                             jcaps)
    tqps, tcaps = tbatched.BSPECS["distinct"].build([p])
    got = tbatched.BSPECS["distinct"].apply(
        tm, (tl[cut].contiguous(),), tk[cut].contiguous(),
        dict(tqps[0], _lane0=g0), tcaps)
    _eq(got, want)
