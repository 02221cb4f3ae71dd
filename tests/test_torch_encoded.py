"""The port's encoded columns against the JAX package's.

Same numpy-seeded columns through ``repro`` and ``repro_torch`` on the CPU:
dictionaries and codes equal ``np.unique``'s, engine masks on encoded
streams bit-identical to the reference's encoded runs (and so to the
decoded ones) for all six algorithms in scan, sharded and two_pass, the
run-level RLE TOP-N bit-identical to the Pallas kernel in interpret mode and
to the flat ladder scan of the expanded column, and ``run_query`` on
dictionary and RLE columns equal to the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distinct import distinct_prune as j_distinct
from repro.core.encoding import dict_encode as j_dict_encode
from repro.core.encoding import rle_encode as j_rle_encode
from repro.core.engine import engine_prune as j_engine
from repro.core.topn import topn_det_prune as j_topn_det
from repro.kernels import ops as jops
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import convert
from repro_torch import core as T
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rle_scan as trle
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt

M = 997  # ragged: m % shards != 0 exercises the pad codes
PARAMS = {
    "topn_det": dict(N=50, w=8),
    "topn_rand": dict(d=128, w=4),
    "distinct": dict(d=64, w=4),
    "skyline": dict(w=8),
    "groupby": dict(d=16, w=4, agg="sum"),
    "having": dict(threshold=40, rows=3, width=512, agg="count"),
}


def _streams(algo, rng, m=M):
    """Low-cardinality columns, so that the dictionaries compress."""
    if algo in ("topn_det", "topn_rand"):
        return (rng.choice(rng.random(97).astype(np.float32) * 1e4 + 1, m),)
    if algo == "distinct":
        return (rng.integers(1, 80, m).astype(np.uint32),)
    if algo == "skyline":
        return (rng.integers(0, 40, (m, 3)).astype(np.float32),)
    return (rng.integers(0, 64, m).astype(np.uint32),
            rng.integers(1, 50, m).astype(np.int32))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ------------------------------------------------------------ encodings
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_dict_encode_matches_np_unique(dtype):
    rng = np.random.default_rng(1)
    v = rng.integers(0, 50, (300,)).astype(dtype)
    if dtype == np.uint32:
        v[::7] = 0xFFFFFFF0  # above 2^31: compared by value, not as int32
    codes, enc = T.dict_encode(v)
    jcodes, jenc = j_dict_encode(v)
    assert codes.dtype == torch.uint32 and enc.lut.dtype == torch.from_numpy(
        v).dtype
    _eq(codes, jcodes)
    _eq(enc.lut, jenc.lut)
    _eq(enc.decode(codes), v)
    # two-dimensional columns (SKYLINE points) share one dictionary
    pts = rng.integers(0, 9, (40, 3)).astype(np.float32)
    c2, e2 = T.dict_encode(pts)
    jc2, je2 = j_dict_encode(pts)
    _eq(c2, jc2)
    _eq(e2.lut, je2.lut)


def test_dict_encode_nan_and_signed_zero_follow_np_unique():
    # np.unique collapses all NaNs into one last entry; torch.unique keeps
    # each NaN apart. Both merge -0.0 and 0.0. The port follows numpy.
    v = np.array([3.0, np.nan, 1.0, np.nan, -0.0, 0.0, 2.0, np.nan],
                 np.float32)
    assert torch.unique(torch.from_numpy(v)).shape[0] == 7
    want_lut, want_codes = np.unique(v, return_inverse=True)
    assert want_lut.shape[0] == 5
    codes, enc = T.dict_encode(v)
    _eq(codes, want_codes.astype(np.uint32))
    _eq(enc.lut, want_lut)  # NaN == NaN here; -0.0 == 0.0 by value
    _eq(codes, j_dict_encode(v)[0])


@pytest.mark.parametrize("v", [[5], [1, 1, 1, 1], [1, 2, 3, 4],
                               [7, 7, 3, 3, 3, 9], [4, 4, 4, 1, 4, 4], []])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_rle_round_trips_match_jax(v, dtype):
    arr = np.asarray(v, dtype)
    rv, rl = T.rle_encode(arr)
    jrv, jrl = j_rle_encode(jnp.asarray(arr))
    assert rl.dtype == torch.int32 and rv.dtype == torch.from_numpy(arr).dtype
    _eq(rv, jrv)
    _eq(rl, jrl)
    _eq(T.rle_expand(rv, rl), arr)
    _eq(T.rle_expand(rv, rl, total=len(v)), arr)
    codes, enc = T.dict_encode(arr)
    assert codes.shape == (len(v),) and enc.size == len(set(v))


def test_with_pad_and_normalize_encodings():
    codes, enc = T.dict_encode(np.array([5, 9, 5], np.uint32))
    padded = enc.with_pad(0xFFFFFFFF)
    assert padded.pad_code == 2 and padded.size == 2
    assert padded.with_pad(1) is padded
    assert int(T.by_value(padded.decode(torch.tensor([2])))[0]) == 0xFFFFFFFF
    with pytest.raises(ValueError, match="pad slot"):
        enc.pad_code
    assert T.normalize_encodings(None, 2) == (None, None)
    assert T.normalize_encodings(enc, 3) == (enc, None, None)
    with pytest.raises(ValueError, match="entries"):
        T.normalize_encodings((enc, enc), 1)
    with pytest.raises(TypeError, match="DictEncoding"):
        T.normalize_encodings(("x",), 1)


# ------------------------------------------------------------ engine
@pytest.mark.parametrize("mode", ["scan", "sharded", "two_pass"])
@pytest.mark.parametrize("algo", list(PARAMS))
def test_engine_encoded_matches_jax(algo, mode):
    """The port's counterpart of tests/test_encoded.py's one-shot bit
    identity, against the reference's own encoded run."""
    rng = np.random.default_rng(len(algo) + len(mode))
    streams = _streams(algo, rng)
    pairs = [T.dict_encode(s) for s in streams]
    jpairs = [j_dict_encode(s) for s in streams]
    for (c, e), (jc, je) in zip(pairs, jpairs):
        _eq(c, jc)
        _eq(e.lut, je.lut)
    kw = dict(mode=mode, shards=8, **PARAMS[algo])
    want = j_engine(algo, *(jc for jc, _ in jpairs),
                    encoding=tuple(je for _, je in jpairs), obs="off", **kw)
    got = T.engine_prune(algo, *(c for c, _ in pairs),
                         encoding=tuple(e for _, e in pairs), **kw)
    plain = T.engine_prune(algo, *(torch.from_numpy(s) for s in streams),
                           **kw)
    eager = T.engine_prune(algo, *(c for c, _ in pairs),
                           encoding=tuple(e for _, e in pairs),
                           decode="eager", **kw)
    _eq(got.keep, want.keep)
    assert torch.equal(got.keep, plain.keep)
    assert torch.equal(eager.keep, plain.keep)
    if algo == "groupby":
        for a, b in zip(got.emitted, want.emitted):
            _eq(a, b)


def test_engine_encoding_from_reference_arrays():
    rng = np.random.default_rng(3)
    (v,) = _streams("topn_det", rng)
    jc, je = j_dict_encode(v)
    enc = convert.dict_encoding_from_numpy(np.asarray(je.lut), device="cpu")
    codes = torch.from_numpy(np.array(jc))
    got = T.engine_prune("topn_det", codes, encoding=enc, mode="two_pass",
                         shards=3, **PARAMS["topn_det"])
    want = j_engine("topn_det", jc, encoding=je, mode="two_pass", shards=3,
                    obs="off", **PARAMS["topn_det"])
    _eq(got.keep, want.keep)
    _eq(got.state.threshold, want.state.threshold)
    with pytest.raises(ValueError, match="decode"):
        T.engine_prune("topn_det", codes, encoding=enc, decode="lazy",
                       **PARAMS["topn_det"])


# ------------------------------------------------------------ RLE scans
def _runs(v):
    rv, rl = T.rle_encode(v)
    return rv, rl, j_rle_encode(jnp.asarray(v))


@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("neg", [False, True], ids=["pos", "withneg"])
def test_rle_topn_matches_pallas_and_expanded(block, neg):
    rng = np.random.default_rng(block)
    m, N, w = 1000, 16, 4
    v = np.repeat(rng.integers(1, 60, m // 5).astype(np.float32), 5)
    if neg:
        v = v - 30.0  # t0 <= 0: ge is not a prefix in the level index
    edges = (v, np.full(300, 7.0, np.float32),
             np.arange(1, 301, dtype=np.float32),
             np.repeat(np.float32([3, -2, 5]), [40, 1, 9]))
    for vv in edges:
        rv, rl, (jrv, jrl) = _runs(vv)
        head, tstar = tops.rle_topn_prune(rv, rl, N=N, w=w, block=block)
        for use_ref in (False, True):  # the Pallas kernel, interpreted
            jh, jt_ = jops.rle_topn_prune(jrv, jrl, N=N, w=w, block=block,
                                          use_ref=use_ref)
            _eq(head, jh)
            _eq(tstar, jt_)
        got = tops.rle_expand_mask(head, tstar, rl, vv.shape[0])
        _eq(got, jops.rle_expand_mask(jh, jt_, jrl, vv.shape[0]))
        _eq(got, j_topn_det(jnp.asarray(vv), N=N, w=w).keep)
        flat = T.topn_det_prune(torch.from_numpy(vv), N=N, w=w).keep
        assert torch.equal(got, flat)


@pytest.mark.parametrize("n_top", [1, 250, 5000])
@pytest.mark.parametrize("w", [1, 8])
def test_rle_topn_ragged_and_n_above_rows(n_top, w):
    rng = np.random.default_rng(n_top + w)
    # runs of random lengths 1..9, values with ties across runs
    lengths = rng.integers(1, 10, 201)
    v = np.repeat(rng.integers(-20, 40, 201).astype(np.float32), lengths)
    rv, rl = T.rle_encode(v)
    head, tstar = tops.rle_topn_prune(rv, rl, N=n_top, w=w, block=16)
    jh, jt_ = jops.rle_topn_prune(*j_rle_encode(jnp.asarray(v)), N=n_top,
                                  w=w, block=16, use_ref=True)
    _eq(head, jh)
    _eq(tstar, jt_)
    got = tops.rle_expand_mask(head, tstar, rl, v.shape[0])
    assert torch.equal(got, T.topn_det_prune(torch.from_numpy(v), N=n_top,
                                             w=w).keep)
    # non-maximal runs (equal neighbours kept apart) give the same mask
    rl1 = torch.ones(v.shape[0], dtype=torch.int32)
    h1, t1 = tops.rle_topn_prune(torch.from_numpy(v), rl1, N=n_top, w=w)
    assert torch.equal(tops.rle_expand_mask(h1, t1, rl1, v.shape[0]), got)


def test_rle_topn_kernel_checks_its_layout():
    with pytest.raises(ValueError, match="multiple"):
        trle.rle_topn_det_kernel(torch.zeros(10), torch.zeros(
            10, dtype=torch.int32), N=2, block=16)
    h, t = trle.rle_topn_det_ref(torch.zeros(0), torch.zeros(
        0, dtype=torch.int32), N=2)
    assert h.shape == (0,) and t.dtype == torch.int32


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_rle_distinct_matches_jax_and_expanded(policy):
    rng = np.random.default_rng(7)
    vals = np.repeat(rng.integers(0, 40, 400).astype(np.uint32), 3)
    rv, rl, (jrv, jrl) = _runs(vals)
    rk = tops.rle_distinct_prune(rv, d=16, w=2, policy=policy)
    jrk = jops.rle_distinct_prune(jrv, d=16, w=2, policy=policy)
    _eq(rk, jrk)
    got = tops.rle_expand_mask(rk, None, rl, vals.shape[0])
    _eq(got, j_distinct(jnp.asarray(vals), d=16, w=2, policy=policy).keep)
    _eq(got, jops.rle_expand_mask(jrk, None, jrl, vals.shape[0]))


# ------------------------------------------------------------ query layer
def _table_pair(rng, m=600):
    cols = {"ip": rng.integers(0, 50, m).astype(np.uint32),
            "rev": rng.choice(rng.gamma(2.0, 50.0, 90).astype(np.float32), m),
            "dur": rng.integers(1, 30, m).astype(np.int32),
            "runs": np.sort(rng.integers(0, 20, m)).astype(np.uint32)}
    return (jt.Table("t", {k: jnp.asarray(v) for k, v in cols.items()}),
            tt.Table.from_numpy("t", cols, device="cpu"))


SPECS = [
    ("distinct", ("ip",), dict(d=32, w=4)),
    ("distinct", ("runs",), dict(d=8, w=2, policy="fifo")),
    ("topn", ("rev",), dict(mode="det", N=20, w=4)),
    ("topn", ("rev",), dict(d=16, w=4, N=20, seed=3)),
    ("having", ("ip", "dur"), dict(threshold=150, rows=3, width=64)),
    ("skyline", ("rev", "dur"), dict(w=4)),
    ("groupby", ("ip", "rev"), dict(d=8, w=2, agg="max")),
]


def _out_eq(kind, got, want):
    if kind == "topn":
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    elif kind == "having":
        assert got == [int(x) for x in want]
    elif kind == "groupby":
        assert got == want
    else:
        _eq(got, want)


@pytest.mark.parametrize("encode", [(), ("dict",), ("rle",)],
                         ids=["plain", "dict", "rle"])
@pytest.mark.parametrize("decode", [None, "eager"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}-{s[1][0]}")
def test_run_query_encoded_matches_jax(spec, encode, decode):
    kind, cols, params = spec
    jtab, ttab = _table_pair(np.random.default_rng(4))
    if encode:
        jtab = jtab.encode(*cols, rle=encode == ("rle",))
        ttab = ttab.encode(*cols, rle=encode == ("rle",))
    a = jq.run_query(jq.QuerySpec(kind, cols, params), jtab, decode=decode,
                     obs="off")
    b = tq.run_query(tq.QuerySpec(kind, cols, params), ttab, decode=decode)
    _eq(b["keep"], a["keep"])
    assert (b["forwarded"], b["total"]) == (a["forwarded"], a["total"])
    _out_eq(kind, b["output"], a["output"])


def test_topn_codes_order_as_f32_above_2_24_as_the_reference():
    """A reference fault the port reproduces (ROADMAP Queue 3): TOP-N on a
    dictionary column orders the codes as f32, which cannot tell codes 2^24
    and 2^24 + 1 apart, so the tie goes to the lower row and the smaller
    value comes first. Both packages answer rows [0, 1] (the true order is
    [1, 0]), bit for bit."""
    codes = np.array([1 << 24, (1 << 24) + 1, 5], np.uint32)
    # 2^24 + 2 distinct f32 values, sorted: 0 .. 2^24, then 2^24 + 2
    lut = np.append(np.arange((1 << 24) + 1), (1 << 24) + 2).astype(
        np.float32)
    spec = ("topn", ("v",), dict(mode="det", N=2, w=4))
    jtab = jt.Table("t", {"v": jt.DictColumn(
        jnp.asarray(codes), jt.DictEncoding(jnp.asarray(lut)))})
    ttab = tt.Table("t", {"v": convert.dict_column_from_numpy(
        codes, lut, device="cpu")})
    a = jq.run_query(jq.QuerySpec(*spec), jtab, obs="off")
    b = tq.run_query(tq.QuerySpec(*spec), ttab)
    _eq(b["keep"], a["keep"])
    _out_eq("topn", b["output"], a["output"])
    assert b["output"][1].tolist() == [0, 1]
    assert b["output"][0].tolist() == [1 << 24, (1 << 24) + 2]


def test_run_query_skyline_on_one_shared_dictionary():
    rng = np.random.default_rng(6)
    pts = rng.integers(0, 30, (500, 2)).astype(np.float32)
    jc, je = j_dict_encode(pts)
    jtab = jt.Table("p", {"a": jt.DictColumn(jc[:, 0], je),
                          "b": jt.DictColumn(jc[:, 1], je)})
    codes, enc = T.dict_encode(pts)
    ttab = tt.Table("p", {"a": tt.DictColumn(codes[:, 0].contiguous(), enc),
                          "b": tt.DictColumn(codes[:, 1].contiguous(), enc)})
    spec = ("skyline", ("a", "b"), dict(w=4))
    a = jq.run_query(jq.QuerySpec(*spec), jtab, obs="off")
    b = tq.run_query(tq.QuerySpec(*spec), ttab)
    _eq(b["keep"], a["keep"])
    _eq(b["output"], a["output"])
    plain = tq.run_query(tq.QuerySpec(*spec), tt.Table.from_numpy(
        "p", {"a": pts[:, 0].copy(), "b": pts[:, 1].copy()}, device="cpu"))
    assert torch.equal(b["output"], plain["output"])


def test_gather_decoded_late_materialization():
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 30, 200).astype(np.uint32)
    ttab = tt.Table("t", {"k": tt.dict_column(vals),
                          "r": tt.rle_column(np.sort(vals), dictionary=True),
                          "p": torch.from_numpy(vals.astype(np.int32))})
    jtab = jt.Table("t", {"k": jt.dict_column(vals),
                          "r": jt.rle_column(np.sort(vals), dictionary=True),
                          "p": jnp.asarray(vals.astype(np.int32))})
    keep = np.zeros(200, bool)
    keep[[3, 17, 99]] = True
    got = ttab.gather_decoded(torch.from_numpy(keep))
    want = jtab.gather_decoded(keep)
    for k in ("k", "r", "p"):
        _eq(got[k], want[k])
    by_idx = ttab.gather_decoded(torch.tensor([99, 3]))
    assert by_idx["k"].view(torch.int32).tolist() == vals[[99, 3]].tolist()
    for k, v in ttab.decoded_cols().items():
        _eq(v, jtab.decoded_cols()[k])
    assert ttab.col("r").num_runs == jtab.col("r").num_runs
    assert ttab.num_rows == 200


def test_columns_from_reference_arrays():
    vals = np.array([4, 4, 9, 1, 1, 1], np.uint32)
    jd, jr = jt.dict_column(vals), jt.rle_column(vals, dictionary=True)
    d = convert.dict_column_from_numpy(np.asarray(jd.codes),
                                       np.asarray(jd.encoding.lut),
                                       device="cpu")
    r = convert.rle_column_from_numpy(np.asarray(jr.run_values),
                                      np.asarray(jr.run_lengths),
                                      np.asarray(jr.encoding.lut),
                                      device="cpu")
    _eq(d.decoded(), vals)
    _eq(r.decoded(), vals)
    plain = convert.rle_column_from_numpy(np.float32([2, 3]), [1, 2],
                                          device="cpu")
    _eq(plain.decoded(), np.float32([2, 3, 3]))
