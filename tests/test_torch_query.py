"""The port's query layer against the JAX package's on one seeded table."""
import numpy as np
import pytest
import torch

from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import convert
from repro_torch.core import Mesh
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt


@pytest.mark.parametrize("m,seed", [(1000, 0), (4099, 3)])
def test_make_uservisits_columns_equal(m, seed):
    a = jt.make_uservisits(m, seed=seed)
    b = tt.make_uservisits(m, seed=seed, device="cpu")
    assert list(a.cols) == list(b.cols)
    for k in a.cols:
        want = np.asarray(a.cols[k])
        got = b.cols[k].numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_make_rankings_columns_equal():
    a = jt.make_rankings(777, seed=4)
    b = tt.make_rankings(777, seed=4, device="cpu")
    for k in a.cols:
        np.testing.assert_array_equal(b.cols[k].numpy(), np.asarray(a.cols[k]))


TOPN = ("topn", ("ad_revenue",), dict(d=64, w=4, N=25))
DISTINCT = ("distinct", ("source_ip",), dict(d=64, w=4, policy="fifo"))
TOPN_DET = ("topn", ("ad_revenue",), dict(mode="det", N=25, w=8))
DISTINCT_LRU = ("distinct", ("source_ip",), dict(d=64, w=4))  # lru default


@pytest.mark.parametrize("spec", [TOPN, DISTINCT, TOPN_DET, DISTINCT_LRU])
@pytest.mark.parametrize("seed", [None, 11])
def test_run_query_matches_jax(spec, seed):
    kind, cols, params = spec
    params = dict(params, **({} if seed is None else {"seed": seed}))
    jtab = jt.make_uservisits(3001, seed=1)
    ttab = tt.make_uservisits(3001, seed=1, device="cpu")
    a = jq.run_query(jq.QuerySpec(kind, cols, params), jtab, obs="off")
    b = tq.run_query(tq.QuerySpec(kind, cols, params), ttab)
    np.testing.assert_array_equal(b["keep"].numpy(), np.asarray(a["keep"]))
    for k in ("forwarded", "total"):
        assert a[k] == b[k]
    assert a["pruned_fraction"] == pytest.approx(b["pruned_fraction"],
                                                 abs=1e-7)
    if kind == "topn":
        np.testing.assert_array_equal(b["output"][0].numpy(), a["output"][0])
        np.testing.assert_array_equal(b["output"][1].numpy(), a["output"][1])
    else:
        assert b["output"].dtype == torch.uint32
        np.testing.assert_array_equal(b["output"].numpy(), a["output"])
        np.testing.assert_array_equal(
            b["output"].numpy(), np.unique(np.asarray(jtab.cols["source_ip"])))


def test_run_query_on_a_converted_table():
    rng = np.random.default_rng(5)
    cols = {"ad_revenue": rng.random(500).astype(np.float32),
            "source_ip": rng.integers(0, 90, 500).astype(np.uint32)}
    table = convert.table_from_numpy(cols, device="cpu")
    jtab = jt.Table("t", {k: v for k, v in cols.items()})
    for kind, c, p in (TOPN, DISTINCT):
        a = jq.run_query(jq.QuerySpec(kind, c, p), jtab, obs="off")
        b = tq.run_query(tq.QuerySpec(kind, c, p), table)
        np.testing.assert_array_equal(b["keep"].numpy(), np.asarray(a["keep"]))
    assert table.num_rows == 500
    assert table.col("source_ip").take([3, 1]).tolist() == \
        cols["source_ip"][[3, 1]].tolist()


MESH2 = Mesh(("cpu",) * 2, axis="data")


# since the mesh is ported, what stays refused with one: tune= (the
# reference's ValueError, for every kind) and the engine's knobs
@pytest.mark.parametrize("kind,cols,params,kw", [
    ("topn", ("ad_revenue",), dict(d=8, w=2, N=5),
     dict(mesh=MESH2, tune="race")),
    ("topn", ("ad_revenue",), dict(d=8, w=2, N=5),
     dict(mesh=MESH2, tune="cached", obs="off")),
    ("topn", ("ad_revenue",), dict(d=8, w=2, N=5),
     dict(mesh=MESH2, options=tq.ExecOptions(decode="eager", tune="race"))),
    ("topn", ("ad_revenue",), dict(d=8, w=2, N=5),
     dict(mesh=MESH2, plan_cache=object(), tune="cached")),
    ("skyline", ("ad_revenue", "duration"), dict(w=2),
     dict(mesh=MESH2, options=tq.ExecOptions(pass2="mesh"))),
    ("groupby", ("source_ip", "ad_revenue"), dict(d=8, w=2),
     dict(mesh=MESH2, tune="race")),
    ("having", ("source_ip", "ad_revenue"), dict(threshold=1.0),
     dict(mesh=MESH2, decode="eager", tune="race")),
    ("join", ("source_ip", "source_ip"), dict(nbits=64),
     dict(mesh=MESH2, tune="race")),
    ("filter", ("duration",), dict(formula=None),
     dict(mesh=MESH2, tune="race")),
])
def test_run_query_not_ported_raises(kind, cols, params, kw):
    table = tt.make_uservisits(64, device="cpu")
    with pytest.raises(ValueError, match="worker mesh|'pass2' option"):
        tq.run_query(tq.QuerySpec(kind, cols, params), table, **kw)
