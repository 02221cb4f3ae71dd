"""The port's serving pieces (``repro_torch.serve``) against the JAX
package's (``repro.serve``), on the CPU, with tolerance 0.

``pruned_topk``: values by their bits and indices equal to the reference's
(``lax.top_k`` order: ties to the lower index, +NaN on top, a NaN with its
sign set at the bottom, -0 below +0), on normals, on integer-valued logits
with ties, and with NaN, +-inf and +-0. ``RequestCache``: the same ``fresh``
lists and fingerprints call for call, on the reference test's sequences and
on a seeded stream of 2000 prompts that evicts from a small cache, across
``reset``, with the ``serve.*`` counters equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.serve import RequestCache as JCache
from repro.serve import pruned_topk as jtopk
from repro_torch import obs as tobs
from repro_torch.core import engine as tengine
from repro_torch.serve import RequestCache as TCache
from repro_torch.serve import pruned_topk as ttopk
from repro_torch.serve.engine import prompt_fingerprints


@pytest.fixture(autouse=True)
def _reset_port():
    """The port's process-wide caches and telemetry, reset around each test
    (the shared conftest resets the JAX package's)."""
    tengine.reset_caches()
    tobs.REGISTRY.reset()
    yield
    tengine.reset_caches()
    tobs.REGISTRY.reset()


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize]) \
        if a.dtype.kind == "f" else a


def _same_topk(lg: np.ndarray, k: int, n_shards: int):
    wv, wi = jtopk(jnp.asarray(lg), k, n_shards)
    gv, gi = ttopk(torch.from_numpy(lg), k, n_shards)
    assert gv.numpy().dtype == np.asarray(wv).dtype
    np.testing.assert_array_equal(_bits(gv.numpy()), _bits(np.asarray(wv)))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("log_shards", [1, 2, 4])
def test_pruned_topk_normals(k, log_shards):
    n_shards = 2 ** log_shards
    V = 16 * n_shards * max(k, 2)
    lg = np.random.default_rng(k * 10 + log_shards).normal(
        size=(3, V)).astype(np.float32)
    _same_topk(lg, k, n_shards)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_pruned_topk_ties(dtype, k):
    """Integer-valued logits from 7 values: every shard holds ties."""
    lg = np.random.default_rng(k).integers(-3, 4, (4, 192)).astype(dtype)
    for n_shards in (1, 4, 16):
        _same_topk(lg, k, n_shards)


SPECIALS = [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0,
            np.finfo(np.float32).max, np.finfo(np.float32).tiny]


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("k", [1, 4, 9])
def test_pruned_topk_specials(dtype, k):
    rng = np.random.default_rng(k)
    vals = np.array(SPECIALS, np.float32)
    vals[1] = -np.abs(vals[1])      # a NaN with its sign bit set
    with np.errstate(over="ignore"):   # FLT_MAX is inf in float16
        vals = vals.astype(dtype)
    assert np.signbit(vals[1]) and not np.signbit(vals[0])
    lg = rng.choice(vals, (5, 160))
    _same_topk(lg, k, 8)
    _same_topk(lg, k, 1)


def test_pruned_topk_refuses_ragged_vocab():
    with pytest.raises(ValueError, match="multiple"):
        ttopk(torch.zeros((2, 10)), 1, 4)


PROMPTS = ["", "a", "ab", "abc", "abcd", "abcde", "q1", "hello world",
           "héllo", "日本語のプロンプト", "x" * 200, "\0\0\0\0\0", "ab\0"]


def test_fp_equal():
    want = [JCache._fp(p) for p in PROMPTS]
    assert [TCache._fp(p) for p in PROMPTS] == want
    got = prompt_fingerprints(PROMPTS, torch.device("cpu"))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy().view(np.uint32), want)


def _calls(cache, batches):
    return [cache.dedup(b) for b in batches]


def test_request_cache_reference_sequences():
    for batches in ([["q1", "q2", "q1", "q3", "q2", "q1"]],
                    [["q1", "q2"], ["q1", "q3", "q2"], ["q3"]]):
        jc, tc = JCache(), TCache(device="cpu")
        assert _calls(tc, batches) == _calls(jc, batches)
        jc.reset()
        tc.reset()
        assert _calls(tc, [["q1"]]) == _calls(jc, [["q1"]]) == \
            [(["q1"], [JCache._fp("q1")])]
        _, fps = tc.dedup(["q1", "zz"])
        tc.put(fps[0], "answer1")
        assert tc.get(TCache._fp("q1")) == "answer1"
        assert tc.get(fps[1]) is None
    assert TCache(device="cpu").dedup([]) == JCache().dedup([])


def _prompt_stream(seed, n, distinct=300):
    """n prompts drawn zipf(1.2) from ``distinct`` strings of 0-40 bytes."""
    rng = np.random.default_rng(seed)
    pool = ["".join(chr(c) for c in rng.integers(32, 0x3000, int(ln)))
            for ln in rng.integers(0, 14, distinct)]
    ranks = (rng.zipf(1.2, n) - 1) % distinct
    return [pool[r] for r in ranks]


@pytest.mark.parametrize("d,w", [(16, 2), (256, 4)])
def test_request_cache_stream(d, w):
    """2000 prompts in 8 calls, a reset, then 3 more calls: the same fresh
    lists and fingerprints, and the same counters."""
    prompts = _prompt_stream(d, 2000)
    batches = [prompts[i * 250:(i + 1) * 250] for i in range(8)]
    jc, tc = JCache(d=d, w=w), TCache(d=d, w=w, device="cpu")
    want, got = _calls(jc, batches), _calls(tc, batches)
    assert got == want
    assert sum(len(f) for f, _ in got) < 2000
    jc.reset()
    tc.reset()
    assert _calls(tc, batches[:3]) == _calls(jc, batches[:3])
    snap_j, snap_t = jobs.REGISTRY.snapshot(), tobs.REGISTRY.snapshot()
    keys = ("serve.dedup_requests", "serve.dedup_pruned")
    assert {k: snap_t[k] for k in keys} == {k: snap_j[k] for k in keys}
    assert snap_t["serve.dedup_requests"] == 2750


def test_request_cache_counters_off():
    tobs.set_default_level("off")
    try:
        TCache(device="cpu").dedup(["a", "a"])
    finally:
        tobs.set_default_level("counters")
    assert "serve.dedup_requests" not in tobs.REGISTRY.snapshot()
