"""The port's FILTER pruning against the JAX package's, on the CPU.

Formulas are written once as nested tuples and built in both packages.
Relaxed trees, basic predicates and every mask (direct evaluation, the 2^n
truth table, switch keep, master completion) are identical, uint32 columns
included (the port compares them by value in int64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filter as jf
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch.core import filter as tf
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt

M = 2000


def _cols(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "u": rng.integers(0, 1 << 32, M, dtype=np.uint64).astype(np.uint32),
        "f": rng.normal(size=M).astype(np.float32) * 100,
        "i": rng.integers(-500, 500, M).astype(np.int32),
        "s": rng.integers(0, 64, M).astype(np.uint32),
    }


def _like(c):
    """An unsupported predicate written for both packages: float or int32
    columns only, no % on uint32."""
    return (c * 3 + 1) > 40


def build(mod, spec):
    """("P", column, op, value[, supported]) | ("A" | "O", [specs]) | "T"."""
    if spec == "T":
        return mod.TRUE()
    if spec[0] == "P":
        col, op, value, *sup = spec[1:]
        if op == "like":
            value = _like
        return mod.Pred(col, op, value, *sup)
    cls = mod.And if spec[0] == "A" else mod.Or
    return cls(tuple(build(mod, s) for s in spec[1]))


def canon(f):
    """A package-independent reading of a formula tree."""
    if type(f).__name__ == "TRUE":
        return "T"
    if type(f).__name__ == "Pred":
        value = "like" if callable(f.value) else f.value
        return ("P", f.column, f.op, value, f.switch_supported)
    return (type(f).__name__, tuple(canon(t) for t in f.terms))


# the JAX package reads a Python int compared with a uint32 column as an
# int32, so values stay below 2^31; the column's values span all of uint32
U_MID = (1 << 31) - 1
FORMULAS = {
    "single": ("P", "f", "gt", 10.0),
    "and_uint32": ("A", [("P", "u", "ge", U_MID), ("P", "s", "lt", 20),
                         ("P", "i", "ne", 3)]),
    "or_unsupported": ("O", [("P", "f", "le", -50.0),
                             ("P", "i", "like", None, False)]),
    "and_unsupported": ("A", [("P", "u", "lt", 2_000_000_000),
                              ("P", "f", "like", None, False),
                              ("O", [("P", "s", "eq", 7),
                                     ("P", "i", "gt", 0)])]),
    "all_unsupported": ("A", [("P", "f", "like", None, False)]),
    "true": "T",
}


def _random_formula(rng, n_preds):
    cols = [("u", lambda: int(rng.integers(0, 1 << 31))),
            ("f", lambda: float(np.float32(rng.normal() * 100))),
            ("i", lambda: int(rng.integers(-500, 500))),
            ("s", lambda: int(rng.integers(0, 64)))]
    preds = []
    for _ in range(n_preds):
        c, val = cols[rng.integers(len(cols))]
        if c in ("f", "i") and rng.random() < 0.15:
            preds.append(("P", c, "like", None, False))
        else:
            preds.append(("P", c, ["gt", "ge", "lt", "le", "eq", "ne"]
                          [rng.integers(6)], val()))
    while len(preds) > 1:
        k = int(rng.integers(2, min(4, len(preds)) + 1))
        group, preds = preds[:k], preds[k:]
        preds.append(("A" if rng.random() < 0.5 else "O", group))
    return preds[0]


for _n in (4, 9, 16):
    FORMULAS[f"random_{_n}"] = _random_formula(np.random.default_rng(_n), _n)


def _both(name, seed=0):
    cols = _cols(seed)
    spec = FORMULAS[name]
    return (build(jf, spec), {k: jnp.asarray(v) for k, v in cols.items()},
            build(tf, spec), {k: torch.from_numpy(v) for k, v in cols.items()})


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", sorted(FORMULAS))
def test_relax_and_basic_preds_same_tree(name):
    jfm, _, tfm, _ = _both(name)
    assert canon(tf.relax(tfm)) == canon(jf.relax(jfm))
    assert [canon(p) for p in tf.basic_preds(tfm)] == \
        [canon(p) for p in jf.basic_preds(jfm)]


@pytest.mark.parametrize("name", sorted(FORMULAS))
def test_evaluate_and_truthtable_masks_match(name):
    jfm, jcols, tfm, tcols = _both(name, seed=len(name))
    got = tf.evaluate(tfm, tcols)
    assert got.dtype == torch.bool and got.shape == (M,)
    _eq(got, jf.evaluate(jfm, jcols))
    _eq(tf.evaluate_truthtable(tfm, tcols), jf.evaluate_truthtable(jfm, jcols))
    _eq(tf.evaluate_truthtable(tfm, tcols), got)


@pytest.mark.parametrize("name", sorted(FORMULAS))
@pytest.mark.parametrize("truthtable", [True, False])
def test_filter_prune_and_master_complete_match(name, truthtable):
    jfm, jcols, tfm, tcols = _both(name, seed=3)
    jr = jf.filter_prune(jfm, jcols, truthtable)
    tr = tf.filter_prune(tfm, tcols, truthtable)
    _eq(tr.keep, jr.keep)
    assert canon(tr.state) == canon(jr.state)
    final = tf.master_complete_filter(tfm, tcols, tr.keep)
    _eq(final, jf.master_complete_filter(jfm, jcols, jr.keep))
    assert bool((tr.keep | ~final).all())  # the switch keeps a superset


def test_truthtable_refuses_seventeen_predicates():
    preds = ("A", [("P", "i", "gt", j) for j in range(17)])
    cols = _cols()
    with pytest.raises(AssertionError):
        jf.evaluate_truthtable(build(jf, preds),
                               {k: jnp.asarray(v) for k, v in cols.items()})
    with pytest.raises(AssertionError):
        tf.evaluate_truthtable(build(tf, preds),
                               {k: torch.from_numpy(v) for k, v in
                                cols.items()})


def _run(kind_cols, spec, jtable, ttable, truthtable=True):
    params = dict(truthtable=truthtable)
    a = jq.run_query(jq.QuerySpec("filter", kind_cols,
                                  dict(formula=build(jf, spec), **params)),
                     jtable, obs="off")
    b = tq.run_query(tq.QuerySpec("filter", kind_cols,
                                  dict(formula=build(tf, spec), **params)),
                     ttable)
    np.testing.assert_array_equal(b["output"].numpy(), a["output"])
    _eq(b["keep"], a["keep"])
    assert (b["forwarded"], b["total"]) == (a["forwarded"], a["total"])
    return a


@pytest.mark.parametrize("truthtable", [True, False])
def test_run_query_filter_rankings(truthtable):
    """The Big Data benchmark's Query 1: page_rank > X."""
    rk, trk = jt.make_rankings(5000, seed=1), tt.make_rankings(5000, seed=1,
                                                               device="cpu")
    x = float(np.quantile(np.asarray(rk.cols["page_rank"]), 0.9))
    a = _run(("page_rank",), ("P", "page_rank", "gt", x), rk, trk,
             truthtable)
    assert 400 < len(a["output"]) < 600


def test_run_query_filter_uservisits_unsupported():
    """A formula with an unsupported predicate on uservisits: relax and the
    truth table both do real work, and the master drops the extra rows."""
    ua = jt.make_uservisits(6000, seed=0)
    tua = tt.make_uservisits(6000, seed=0, device="cpu")
    spec = ("A", [("P", "lang", "lt", 16),
                  ("O", [("P", "duration", "like", None, False),
                         ("P", "ad_revenue", "gt", 150.0)]),
                  ("P", "source_ip", "ne", 0)])
    a = _run(("lang", "duration", "ad_revenue", "source_ip"), spec, ua, tua)
    assert len(a["output"]) < a["forwarded"] < a["total"]
