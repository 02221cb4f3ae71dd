"""The plain versions of the port's CUDA kernels against the JAX kernels.

Each JAX kernel runs as the JAX package's own tests run it on the CPU: the
Pallas kernel in interpret mode, and its jnp oracle (``use_ref=True``).
Masks and states must be bit-identical. The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels import ops as jops
from repro.kernels import parallel as jpar
from repro.kernels import ref as jref
from repro.kernels.distinct_prune import distinct_prune_kernel as j_dpk
from repro.kernels.topn_prune import topn_prune_kernel as j_tpk
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parallel as tpar
from repro_torch.kernels import ref as tref
from repro_torch.kernels.distinct_prune import distinct_prune_kernel
from repro_torch.kernels.topn_prune import topn_prune_kernel

D, W = 64, 4


def _data(m, seed=0, universe=300):
    rng = np.random.default_rng(seed)
    v = rng.gamma(2.0, 50.0, m).astype(np.float32)
    f = rng.integers(0, universe, m).astype(np.uint32)
    return v, f


def _m(block):
    # interpret-mode Pallas at B = 1 steps one entry per grid step
    return 1024 if block == 1 else 4099


@pytest.mark.parametrize("block", [1, 16, 256])
@pytest.mark.parametrize("seed", [0, 5])
def test_topn_prune_matches_pallas_and_ref(block, seed):
    v, _ = _data(_m(block), seed)
    got = tops.topn_prune(torch.from_numpy(v), d=D, w=W, block=block,
                          seed=seed).numpy()
    for use_ref in (False, True):
        want = np.asarray(jops.topn_prune(jnp.asarray(v), d=D, w=W,
                                          block=block, seed=seed,
                                          use_ref=use_ref))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [1, 16, 256])
@pytest.mark.parametrize("seed", [0, 5])
def test_distinct_prune_matches_pallas_and_ref(block, seed):
    _, f = _data(_m(block), seed)
    got = tops.distinct_prune(torch.from_numpy(f), d=D, w=W, block=block,
                              seed=seed).numpy()
    for use_ref in (False, True):
        want = np.asarray(jops.distinct_prune(jnp.asarray(f), d=D, w=W,
                                              block=block, seed=seed,
                                              use_ref=use_ref))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [1, 16, 256])
@pytest.mark.parametrize("algo", ["topn", "distinct"])
def test_prune_parallel_matches_pallas_and_ref(block, algo):
    v, f = _data(_m(block), 2)
    x = v if algo == "topn" else f
    jfn = getattr(jops, f"{algo}_prune_parallel")
    tfn = getattr(tops, f"{algo}_prune_parallel")
    got = tfn(torch.from_numpy(x), d=D, w=W, shards=4, block=block,
              seed=1).numpy()
    for use_ref in (False, True):
        want = np.asarray(jfn(jnp.asarray(x), d=D, w=W, shards=4,
                              block=block, seed=1, use_ref=use_ref))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [1, 16])
def test_block_ref_states_match(block):
    v, f = _data(512, 3)
    k, st = tref.topn_block_ref(torch.from_numpy(v), d=D, w=W, block=block,
                                seed=2, return_state=True)
    jk, jst = jref.topn_block_ref(jnp.asarray(v), d=D, w=W, block=block,
                                  seed=2, return_state=True)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk).astype(bool))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    k, (slots, valid, head) = tref.distinct_block_ref(
        torch.from_numpy(f), d=D, w=W, block=block, seed=2, return_state=True)
    jk, (js, jv, jh) = jref.distinct_block_ref(
        jnp.asarray(f), d=D, w=W, block=block, seed=2, return_state=True)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk).astype(bool))
    assert slots.dtype == torch.uint32
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(head.numpy(), np.asarray(jh))


@pytest.mark.parametrize("shards,block", [(1, 256), (4, 16), (8, 1)])
def test_shard_states_match_pallas(shards, block):
    m = shards * block * (8 if block > 1 else 64)
    v, f = _data(m, 4)
    keep, states = tpar.topn_shard_states_kernel(
        torch.from_numpy(v), d=D, w=W, shards=shards, block=block, seed=3)
    jkeep, jstates = jpar.topn_shard_states_kernel(
        jnp.asarray(v), d=D, w=W, shards=shards, block=block, seed=3)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep).astype(bool))
    np.testing.assert_array_equal(states.numpy(), np.asarray(jstates))
    keep, slots, valid, head = tpar.distinct_shard_states_kernel(
        torch.from_numpy(f), d=D, w=W, shards=shards, block=block, seed=3)
    jkeep, lo, hi, jvalid = jpar.distinct_shard_states_kernel(
        jnp.asarray(f), d=D, w=W, shards=shards, block=block, seed=3)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep).astype(bool))
    jslots, jv = convert.distinct_kernel_state_from_numpy(
        np.asarray(lo), np.asarray(hi), np.asarray(jvalid), device="cpu")
    # an invalid slot holds 0 on both sides, so the halves view is exact
    np.testing.assert_array_equal(slots.numpy(), jslots.numpy())
    np.testing.assert_array_equal(valid.numpy(), jv.numpy())
    np.testing.assert_array_equal(
        (slots.view(torch.int32).to(torch.int64) & 0xFFFF).numpy(),
        np.asarray(lo).astype(np.int64))
    assert head.shape == (shards, D)


# The streams the staged block kernels are held to on the card
# (chip_smoke.phase_kernels_block_staged), here through the plain versions
# against the Pallas kernels at B = 256: (stream, d, w, lanes of n
# entries); n = 256 is a lane of one chunk, 19 chunks are one stage of 16
# and 3 more.
STAGED_TOPN = [("gamma", D, W, 256 * 3), ("ascending", D, W, 256 * 3),
               ("equal, +-0 and NaNs", D, W, 256 * 3), ("gamma", 1, W, 256),
               ("gamma", 8, 64, 256), ("gamma", D, W, 256 * 19),
               ("view at 1", D, W, 256 * 2), ("view at 3", D, W, 256 * 2)]
STAGED_DISTINCT = [("universe 300", D, W, 256 * 3),
                   ("all distinct", D, W, 256 * 3),
                   ("universe 300", 1, W, 256),
                   ("float32 integers", D, W, 256 * 3),
                   ("universe 300", D, W, 256 * 19),
                   ("view at 1", D, W, 256 * 2), ("view at 3", D, W, 256 * 2)]


def _view_at(x, off):
    """x as the view [off : off + len(x)] of a longer tensor."""
    big = torch.zeros(x.numel() + 8, dtype=x.dtype)
    big[off:off + x.numel()] = x
    return big[off:off + x.numel()]


def _staged_stream(name, m, rng, topn):
    """(port tensor, JAX array) of one stream of the staged cases."""
    if name in ("gamma", "universe 300") or name.startswith("view"):
        v, f = _data(m, int(rng.integers(100)))
        x = v if topn else f
    elif name == "ascending":
        x = np.arange(m, dtype=np.float32)
    elif name == "all distinct":
        x = np.arange(m, dtype=np.uint32)
    elif name == "equal, +-0 and NaNs":
        pick = np.array([3.0, 3.0, 3.0, 0.0, -0.0, np.nan, 0.0], np.float32)
        pick.view(np.int32)[-1] = -4194304  # a NaN with its sign set
        x = pick[rng.integers(0, len(pick), m)]
    else:  # float32 integers: the port hashes the bits and stores the value
        x = rng.integers(0, 300, m).astype(np.float32)
    t = torch.from_numpy(x)
    if name.startswith("view"):
        t = _view_at(t, int(name[-1]))
    return t, x


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("name,d,w,n", STAGED_TOPN,
                         ids=[f"{c[0]}-d{c[1]}-w{c[2]}-n{c[3]}"
                              for c in STAGED_TOPN])
def test_topn_block_streams_match_pallas(name, d, w, n, shards):
    rng = np.random.default_rng(n + d)
    t, x = _staged_stream(name, shards * n, rng, topn=True)
    keep, states = tpar.topn_shard_states_kernel(t, d=d, w=w, shards=shards,
                                                 block=256, seed=5)
    jkeep, jstates = jpar.topn_shard_states_kernel(
        jnp.asarray(x), d=d, w=w, shards=shards, block=256, seed=5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep).astype(bool))
    np.testing.assert_array_equal(states.numpy(), np.asarray(jstates))


@pytest.mark.parametrize("shards", [4, 8])
@pytest.mark.parametrize("name,d,w,n", STAGED_DISTINCT,
                         ids=[f"{c[0]}-d{c[1]}-w{c[2]}-n{c[3]}"
                              for c in STAGED_DISTINCT])
def test_distinct_block_streams_match_pallas(name, d, w, n, shards):
    """float32 integers below 2^24: the port hashes the value's bits and
    stores the value, so the Pallas kernel on the bits as uint32 keys gives
    the same keep, valid and head, and slots that hold the bits."""
    rng = np.random.default_rng(n + d)
    t, x = _staged_stream(name, shards * n, rng, topn=False)
    fl = x.dtype == np.float32
    keep, slots, valid, head = tpar.distinct_shard_states_kernel(
        t, d=d, w=w, shards=shards, block=256, seed=5)
    jkeep, lo, hi, jvalid = jpar.distinct_shard_states_kernel(
        jnp.asarray(x.view(np.uint32)), d=d, w=w, shards=shards, block=256,
        seed=5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep).astype(bool))
    jslots, jv = convert.distinct_kernel_state_from_numpy(
        np.asarray(lo), np.asarray(hi), np.asarray(jvalid), device="cpu")
    if fl:  # a valid slot holds the value's bits there, the value here
        jslots = torch.where(jv, jslots.view(torch.float32).to(torch.int64),
                             0).to(torch.int32).view(torch.uint32)
    np.testing.assert_array_equal(slots.numpy(), jslots.numpy())
    np.testing.assert_array_equal(valid.numpy(), jv.numpy())
    # the Pallas kernel keeps head to itself; until a row fills, its head is
    # its count of valid slots
    filled = valid.sum(-1)
    assert head.shape == (shards, d)
    np.testing.assert_array_equal(head[filled < w].numpy(),
                                  filled[filled < w].numpy())


def test_s1_identities():
    """ops' sequential kernel is the pass-1 keep of one shard, and at B = 1
    the block semantics are the engine's per-entry scans."""
    v, f = _data(1024, 6)
    tv, tf = torch.from_numpy(v), torch.from_numpy(f)
    a = np.asarray(j_tpk(jnp.asarray(v), d=D, w=W, block=256))
    b = np.asarray(jpar.topn_shard_states_kernel(
        jnp.asarray(v), d=D, w=W, shards=1, block=256)[0])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(topn_prune_kernel(tv, d=D, w=W).numpy(),
                                  a.astype(bool))
    a = np.asarray(j_dpk(jnp.asarray(f), d=D, w=W, block=256))
    b = np.asarray(jpar.distinct_shard_states_kernel(
        jnp.asarray(f), d=D, w=W, shards=1, block=256)[0])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(distinct_prune_kernel(tf, d=D, w=W).numpy(),
                                  a.astype(bool))
    scan = np.asarray(jcore.topn_rand_prune(jnp.asarray(v), d=D, w=W).keep)
    np.testing.assert_array_equal(
        tref.topn_block_ref(tv, d=D, w=W, block=1).numpy(), scan)
    scan = np.asarray(jcore.distinct_prune(jnp.asarray(f), d=D, w=W,
                                           policy="fifo").keep)
    np.testing.assert_array_equal(
        tref.distinct_block_ref(tf, d=D, w=W, block=1).numpy(), scan)


@pytest.mark.parametrize("shards", [1, 4])
def test_apply_plain_matches_pallas(shards):
    m = shards * 256 * 2
    v, f = _data(m, 7)
    _, jstates = jpar.topn_shard_states_kernel(
        jnp.asarray(v), d=D, w=W, shards=shards, block=256)
    jmerged = jpar.merge_topn_states(jstates, W)
    merged = tpar.merge_topn_states(torch.from_numpy(np.array(jstates)), W)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jmerged))
    want = np.asarray(jpar.topn_apply_kernel(jnp.asarray(v), jmerged, d=D,
                                             shards=shards, block=256))
    got = tpar.topn_apply_kernel(torch.from_numpy(v), merged, d=D,
                                 shards=shards)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    keep1, lo, hi, jvalid = jpar.distinct_shard_states_kernel(
        jnp.asarray(f), d=D, w=W, shards=shards, block=256)
    mlo, mhi, owner = jpar.merge_distinct_states(lo, hi, jvalid)
    want = np.asarray(jpar.distinct_apply_kernel(
        jnp.asarray(f), keep1, mlo, mhi, owner, d=D, shards=shards,
        block=256))
    slots, valid = convert.distinct_kernel_state_from_numpy(
        np.asarray(lo), np.asarray(hi), np.asarray(jvalid), device="cpu")
    mslots, mvalid = tpar.merge_distinct_states(slots, valid)
    got = tpar.distinct_apply_kernel(
        torch.from_numpy(f), torch.from_numpy(np.asarray(keep1) > 0),
        mslots, mvalid, d=D, shards=shards)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    # owner codes: shard rank + 1 on valid columns, in cols_by_shard order
    own = np.where(mvalid.numpy(), np.repeat(np.arange(shards) + 1.0, W), 0.0)
    np.testing.assert_array_equal(own, np.asarray(owner))


def test_pad_to_fills():
    x = torch.arange(5, dtype=torch.float32)
    p, m = tops._pad_to(x, 4, -1.0)
    assert m == 5 and p.tolist() == [0, 1, 2, 3, 4, -1, -1, -1]
    u = torch.tensor([7, 0xFFFFFFFF], dtype=torch.int64).to(torch.int32) \
        .view(torch.uint32)
    p, m = tops._pad_to(u, 3, 0)
    assert p.dtype == torch.uint32 and m == 2
    assert (p.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).tolist() == \
        [7, 0xFFFFFFFF, 0]


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="2\\^16"):
        tops.topn_prune(torch.zeros(8), d=1 << 16, w=2)
    with pytest.raises(ValueError, match="multiple of block"):
        tpar.topn_shard_states_kernel(torch.zeros(10), d=8, w=2, shards=2,
                                      block=4)


def test_missing_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        tcommon.find_nvcc()


def test_launch_counts_reset():
    for k in tpar.KERNELS:
        k.launches = 3
    tpar.reset_launch_counts()
    assert [k.launches for k in tpar.KERNELS] == [0] * len(tpar.KERNELS)
    # the plain versions on the CPU never count as launches
    tops.topn_prune_parallel(torch.rand(512), d=D, w=W, shards=2, block=16)
    tops.skyline_prune_parallel(torch.rand(512, 2), w=W, shards=2, block=16)
    tops.cms_query(tops.cms_build(torch.zeros(64, dtype=torch.int32),
                                  torch.ones(64), rows=2, width=8),
                   torch.zeros(64, dtype=torch.int32))
    tops.bloom_query(tops.bloom_build(torch.arange(64, dtype=torch.int32),
                                      nbits=256), torch.zeros(64))
    tcore.engine_prune("groupby", torch.arange(64, dtype=torch.int32),
                       torch.ones(64), d=4, w=2, mode="two_pass", shards=2)
    tcore.engine_prune("topn_det", torch.rand(64), N=4, mode="two_pass",
                       shards=2)
    tcore.engine_prune("distinct", torch.arange(64, dtype=torch.int32).view(
        torch.uint32), d=4, w=2, mode="two_pass", shards=2)
    tops.rle_topn_prune(torch.rand(8), torch.ones(8, dtype=torch.int32), N=2)
    tcore.engine_prune_batch("distinct", [dict(d=4, w=2), dict(d=8, w=1)],
                             torch.arange(64, dtype=torch.int32).view(
                                 torch.uint32), mode="two_pass", shards=2)
    assert [k.launches for k in tpar.KERNELS] == [0] * len(tpar.KERNELS)
    assert len({k.name for k in tpar.KERNELS}) == 24


def test_apply_shape_checks():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="merged"):
        tpar.topn_apply_kernel(x, torch.zeros(4, 2), d=8, shards=2)
    f = torch.zeros(8, dtype=torch.int32).view(torch.uint32)
    slots = torch.zeros((8, 6), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError, match="union"):
        tpar.distinct_apply_kernel(f, torch.ones(8, dtype=torch.bool), slots,
                                   torch.zeros((8, 6), dtype=torch.bool),
                                   d=8, shards=4)
