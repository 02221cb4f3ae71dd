"""The port's Bloom filter and JOIN against the JAX package's, on the CPU.

Same numpy-seeded keys through both packages. The JAX Bloom kernels run as
the JAX package's own tests run them: Pallas in interpret mode, and the jnp
oracle (``use_ref=True``). Bits, masks and join outputs are bit-identical:
a Bloom filter is an OR of bits, exact in any order, and the join is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.kernels import bloom_filter as jbloom
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.query import engine as jq
from repro.query import tables as jt
from repro_torch import convert
from repro_torch import core as T
from repro_torch.kernels import bloom_filter as tbloom
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.query import engine as tq
from repro_torch.query import tables as tt


def _keys(m, seed=0, hi=1 << 32):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, hi, m, dtype=np.uint64).astype(np.uint32)
    if m > 3:
        k[1] = np.uint32(0xFFFFFFFF)
        k[2] = np.uint32(0)
    return k


def _eq(t, j):
    t = t.view(torch.int32) if t.dtype == torch.uint32 else t
    j = np.asarray(j)
    j = j.view(np.int32) if j.dtype == np.uint32 else j
    np.testing.assert_array_equal(t.numpy(), j)


def _triples(out):
    return list(zip(*(c.tolist() for c in out)))


# ------------------------------------------------------------- kernels
SHAPES = [(1024, 2, 128), (8192, 4, 256)]


@pytest.mark.parametrize("nbits,H,block", SHAPES)
@pytest.mark.parametrize("m", [256, 1000])
@pytest.mark.parametrize("use_ref", [False, True])
def test_ops_bloom_matches_pallas_and_ref(nbits, H, block, m, use_ref):
    """f32 0/1 bits and query masks over present and absent keys, ragged m
    included (the build pads by repeating keys[0], the query with 0)."""
    k = _keys(m, seed=nbits + m)
    q = np.concatenate([k[: m // 3], _keys(m, seed=99)])
    got = tops.bloom_build(torch.from_numpy(k), nbits=nbits, num_hashes=H,
                           block=block, seed=3)
    ok = tops.bloom_query(got, torch.from_numpy(q), num_hashes=H,
                          block=block, seed=3)
    want = jops.bloom_build(jnp.asarray(k), nbits=nbits, num_hashes=H,
                            block=block, seed=3, use_ref=use_ref)
    assert got.dtype == torch.float32 and ok.dtype == torch.bool
    _eq(got, want)
    _eq(ok, jops.bloom_query(want, jnp.asarray(q), num_hashes=H, block=block,
                             seed=3, use_ref=use_ref))
    assert bool(ok[: m // 3].all())  # no false negatives


@pytest.mark.parametrize("nbits,H,block", SHAPES)
def test_bloom_kernel_level_outputs(nbits, H, block):
    """The interpret-mode Pallas kernels' f32[nbits] and int32[m] outputs
    against the port's ref.py versions, at a whole number of blocks."""
    k = _keys(4 * block, seed=H)
    bits = tref.bloom_build_ref(torch.from_numpy(k), nbits=nbits,
                                num_hashes=H, seed=11)
    jbits = jbloom.bloom_build_kernel(jnp.asarray(k), nbits=nbits,
                                      num_hashes=H, block=block, seed=11)
    _eq(bits, jbits)
    _eq(bits, jref.bloom_build_ref(jnp.asarray(k), nbits=nbits, num_hashes=H,
                                   seed=11))
    q = np.concatenate([k[:block], _keys(3 * block, seed=7)])
    got = tref.bloom_query_ref(bits, torch.from_numpy(q), num_hashes=H,
                               seed=11)
    assert got.dtype == torch.int32
    _eq(got, jbloom.bloom_query_kernel(jbits, jnp.asarray(q), num_hashes=H,
                                       block=block, seed=11))


def test_ops_bloom_query_reads_bits_above_half():
    """The query tests ``bits > 0.5``, as the Pallas kernel's min does."""
    bits = np.random.default_rng(4).random(1024).astype(np.float32)
    k = _keys(500, seed=4)
    _eq(tops.bloom_query(torch.from_numpy(bits), torch.from_numpy(k),
                         num_hashes=2),
        jops.bloom_query(jnp.asarray(bits), jnp.asarray(k), num_hashes=2,
                         use_ref=True))


def test_kernel_family_caps_nbits():
    with pytest.raises(ValueError, match="2\\^16"):
        tops.bloom_build(torch.zeros(256, dtype=torch.int32), nbits=1 << 16)


@pytest.mark.parametrize("nbits", [37, 1024, 1 << 17])
def test_pack_unpack_round_trip(nbits):
    bits = torch.from_numpy(np.random.default_rng(nbits).random(nbits) < 0.3)
    words = tbloom.pack_bits(bits)
    assert words.dtype == torch.uint32 and words.shape == (-(-nbits // 32),)
    assert torch.equal(tbloom.unpack_bits(words, nbits), bits)


# ------------------------------------------------------ engine family
@pytest.mark.parametrize("nbits", [1000, 1 << 17])
@pytest.mark.parametrize("with_mask", [False, True])
def test_engine_bloom_matches(nbits, with_mask):
    """multi_hash (modulo on both sides of 2^16): bits with and without
    mask=, and the query."""
    k = _keys(3000, seed=5, hi=5000)
    mask = np.random.default_rng(6).random(3000) < 0.5
    jf = J.bloom_build(jnp.asarray(k), nbits, 3, seed=5,
                       mask=jnp.asarray(mask) if with_mask else None)
    tf = T.bloom_build(torch.from_numpy(k), nbits, 3, seed=5,
                       mask=torch.from_numpy(mask) if with_mask else None)
    _eq(tf.bits, jf.bits)
    q = _keys(2000, seed=8, hi=6000)
    _eq(T.bloom_query(tf, torch.from_numpy(q)),
        J.bloom_query(jf, jnp.asarray(q)))


def test_bloom_filter_from_numpy_carries_the_jax_filter():
    k = _keys(800, seed=9)
    jf = J.bloom_build(jnp.asarray(k), 4096, 4, seed=21)
    tf = convert.bloom_filter_from_numpy(np.asarray(jf.bits), num_hashes=4,
                                         seed=21, device="cpu")
    _eq(tf.bits, jf.bits)
    q = _keys(1500, seed=10)
    _eq(T.bloom_query(tf, torch.from_numpy(q)),
        J.bloom_query(jf, jnp.asarray(q)))


# ---------------------------------------------------------------- JOIN
@pytest.mark.parametrize("nbits", [256, 1 << 12])
def test_join_prune_masks_match(nbits):
    ka, kb = _keys(1200, seed=1, hi=900), _keys(700, seed=2, hi=900)
    ja, jb = J.join_prune(jnp.asarray(ka), jnp.asarray(kb), nbits=nbits,
                          num_hashes=3, seed=4)
    ta, tb = T.join_prune(torch.from_numpy(ka), torch.from_numpy(kb),
                          nbits=nbits, num_hashes=3, seed=4)
    _eq(ta.keep, ja.keep)
    _eq(tb.keep, jb.keep)
    _eq(ta.state.bits, ja.state.bits)
    _eq(tb.state.bits, jb.state.bits)


def test_join_prune_asymmetric_masks_match():
    ks, kl = _keys(300, seed=3, hi=2000), _keys(5000, seed=4, hi=2000)
    js, jl = J.join_prune_asymmetric(jnp.asarray(ks), jnp.asarray(kl),
                                     nbits=2048, num_hashes=2, seed=1)
    ts, tl = T.join_prune_asymmetric(torch.from_numpy(ks),
                                     torch.from_numpy(kl), nbits=2048,
                                     num_hashes=2, seed=1)
    _eq(ts.keep, js.keep)
    _eq(tl.keep, jl.keep)
    _eq(ts.state.bits, js.state.bits)
    assert tl.state is None and jl.state is None


@pytest.mark.parametrize("payload", ["float", "int"])
def test_master_complete_join_many_to_many(payload):
    """Duplicate keys on both sides, tied payloads, keep masks: the three
    aligned tensors read as the JAX package's sorted list of triples."""
    rng = np.random.default_rng(12)
    ka = rng.integers(0, 40, 600).astype(np.uint32)
    kb = rng.integers(20, 60, 300).astype(np.uint32)
    if payload == "float":
        va = rng.integers(0, 5, 600).astype(np.float32) / 4
        vb = rng.normal(size=300).astype(np.float32)
    else:
        va = rng.integers(-3, 3, 600).astype(np.int32)
        vb = rng.integers(0, 4, 300).astype(np.int32)
    ma, mb = rng.random(600) < 0.7, rng.random(300) < 0.6
    want = J.master_complete_join(ka, va, ma, kb, vb, mb)
    got = T.master_complete_join(*(torch.from_numpy(x) for x in
                                   (ka, va, ma, kb, vb, mb)))
    assert len(want) > 500
    assert _triples(got) == want
    assert _triples(T.join_oracle(*(torch.from_numpy(x) for x in
                                    (ka, va, kb, vb)))) == \
        J.join_oracle(jnp.asarray(ka), jnp.asarray(va), jnp.asarray(kb),
                      jnp.asarray(vb))


def test_master_complete_join_empty():
    z = torch.zeros(0, dtype=torch.int32).view(torch.uint32)
    f = torch.zeros(0)
    got = T.master_complete_join(z, f, torch.zeros(0, dtype=torch.bool),
                                 z, f, torch.zeros(0, dtype=torch.bool))
    assert all(c.numel() == 0 for c in got)


def _run_both(spec_cols, params, jtabs, ttabs):
    a = jq.run_query(jq.QuerySpec("join", spec_cols, params), jtabs,
                     obs="off")
    b = tq.run_query(tq.QuerySpec("join", spec_cols, params), ttabs)
    assert _triples(b["output"]) == a["output"]
    _eq(b["keep"], a["keep"])
    assert (b["forwarded"], b["total"]) == (a["forwarded"], a["total"])
    return a, b


def test_run_query_join_products_ratings():
    """The paper's Table 1, built by each package's make_products_ratings."""
    products, ratings = jt.make_products_ratings()
    tp, tr = tt.make_products_ratings(device="cpu")
    for jtab, ttab in ((products, tp), (ratings, tr)):
        assert (ttab.name, list(ttab.cols)) == (jtab.name, list(jtab.cols))
        for c, v in jtab.cols.items():
            assert str(ttab.cols[c].dtype) == f"torch.{np.asarray(v).dtype}"
            _eq(ttab.cols[c], v)
    a, _ = _run_both(("name", "name"),
                     dict(nbits=64, payload_a="price", payload_b="taste"),
                     (products, ratings), (tp, tr))
    assert len(a["output"]) == 4


def test_run_query_join_uservisits_rankings():
    """The Big Data benchmark's Query 3 join, at 16000 x 8000 rows."""
    ua, rk = jt.make_uservisits(16000, seed=0), jt.make_rankings(8000, seed=1)
    tua = tt.make_uservisits(16000, seed=0, device="cpu")
    trk = tt.make_rankings(8000, seed=1, device="cpu")
    a, b = _run_both(("dest_url", "page_url"),
                     dict(nbits=1 << 14, num_hashes=3,
                          payload_a="ad_revenue", payload_b="page_rank"),
                     (ua, rk), (tua, trk))
    assert len(a["output"]) > 10000
    assert 0 < b["pruned_fraction"] < 1
