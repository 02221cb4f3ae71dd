"""The chunked scan of the ``topn_det`` ladder kernel, as a short pure-torch
mirror, bit for bit against the JAX package's scan.

After the first N entries of a lane its t0 is fixed, and so are its levels
t0 * 2^i; a level's count is then a plain prefix count. So
``csrc/topn_det.cu`` cuts every lane into chunks of C entries and runs on
every chunk of every lane at once:

1. warm-up: each chunk that holds entries j < N takes the minimum of those
   entries (NaN-propagating, in stream order, from POS); an exclusive
   min-scan over the chunks gives each warm chunk its entering t0, and the
   total, the lane's final t0, is the t0 of every later chunk;
2. count: each chunk counts, per level i, its entries with
   x_j >= t0_j * 2^i, t0_j the running t0 inside a warm chunk;
3. scan: an exclusive sum-scan of those counts over the chunks of each
   (lane, level) gives each chunk its entering counts, and the totals the
   lane's final counts;
4. replay: each chunk walks its entries from its entering counts; cur_j is
   the highest level whose count reached N, and an entry is kept while warm
   or when x_j >= t0_j * 2^cur_j.

The mirror below is that design on the CPU. Chunk sizes put N inside a
chunk, on a chunk boundary and one either side of it, and past the shard.
It is held against ``repro.core.topn.topn_det_prune`` run on each lane:
keep and the final (t0, counts, seen, cur_level), bit for bit, NaNs as one
(``assert_array_equal``). This is the CPU evidence that the chunked scan is
exact; the kernel runs only on the card, where ``chip_smoke.py`` holds it
against the plain version and the serial kernel it replaced.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.topn import topn_det_prune
from repro_torch.constants import NEG, POS

N_SMALL = 12
LANE = 61
FLT_MAX = np.finfo(np.float32).max


def nan_min(a, b):
    """jnp.minimum with ``a`` the earlier operand: a NaN wins, and of equal
    values (-0, +0) the earlier stays, as in a serial fold."""
    return torch.where(a.isnan(), a, torch.where(b.isnan() | (b < a), b, a))


def ladder_chunks(x, *, N, w, C):
    """The chunked scan over lanes x f32[S, n] in chunks of C entries:
    (keep bool[S, n], (t0 f32[S], counts int32[S, w], seen int32[S],
    cur_level int32[S]))."""
    S, n = x.shape
    K = -(-n // C)
    pos = torch.tensor(float(POS))
    xp = torch.cat([x, pos.expand(S, K * C - n)], 1).view(S, K, C)
    j = torch.arange(K * C).view(K, C)
    inl = j < n
    warm = inl & (j < N)
    # 1. warm-up: chunk minima, then their exclusive min-scan
    warm_chunks = -(-min(n, N) // C) if min(n, N) > 0 else 0
    cmin = pos.expand(S, K).clone()
    for c in range(C):
        cmin = torch.where(warm[:, c], nan_min(cmin, xp[:, :, c]), cmin)
    enter = torch.empty(S, K)
    run = pos.expand(S).clone()
    for k in range(warm_chunks):
        enter[:, k] = run
        run = nan_min(run, cmin[:, k])
    t_final = run
    enter[:, warm_chunks:] = t_final[:, None]
    t0 = torch.empty(S, K, C)
    run = enter.clone()
    for c in range(C):
        run = torch.where(warm[:, c], nan_min(run, xp[:, :, c]), run)
        t0[:, :, c] = run
    # 2. per-level chunk counts
    p2 = torch.tensor([2.0 ** i for i in range(w)], dtype=torch.float32)
    ge = (xp[..., None] >= t0[..., None] * p2) & inl[..., None]
    cnt = ge.sum(2, dtype=torch.int32)                       # [S, K, w]
    # 3. exclusive sum-scan over the chunks of each (lane, level)
    enter_counts = torch.cumsum(cnt, 1, dtype=torch.int32) - cnt
    totals = cnt.sum(1, dtype=torch.int32)
    # 4. replay each chunk from its entering counts
    counts = enter_counts[:, :, None, :] + torch.cumsum(ge, 2,
                                                        dtype=torch.int32)
    levels = torch.arange(w, dtype=torch.int32)
    cur = torch.where(counts >= N, levels, -1).amax(-1)
    thr = torch.where(cur >= 0, t0 * p2[cur.clamp(min=0)],
                      torch.tensor(float(NEG)))
    keep = (warm | (xp >= thr)).view(S, K * C)[:, :n]
    cur_final = torch.where(totals >= N, levels, -1).amax(-1)
    seen = torch.full((S,), n, dtype=torch.int32)
    return keep, (t_final, totals, seen, cur_final.to(torch.int32))


def stream(name, S, n, seed):
    rng = np.random.default_rng(seed)
    m = S * n
    r = rng.gamma(2.0, 50.0, m).astype(np.float32)
    if name == "random":
        return r
    if name == "ascending":       # every level fills
        return np.tile(np.arange(1, n + 1, dtype=np.float32), S)
    if name == "constant":
        return np.full(m, 7.5, np.float32)
    if name == "negatives":       # t0 <= 0: the levels fall, not rise
        return r - 120.0
    if name == "nan in the warm-up":
        v = r.reshape(S, n).copy()
        v[:, 3] = np.nan
        return v.reshape(m)
    if name == "nan after it":
        v = r.reshape(S, n).copy()
        v[:, n - 9] = np.nan
        return v.reshape(m)
    if name == "inf, -0":
        odd = np.array([np.inf, -np.inf, -0.0, 0.0], np.float32)
        v = r - 60.0
        v[::5] = rng.choice(odd, v[::5].size)
        return v
    if name == "near FLT_MAX":    # t0 stays POS; levels overflow to inf
        v = (rng.random(m) * 2.4e38 + 1e38).astype(np.float32)
        v[::4] = FLT_MAX
        return v
    raise KeyError(name)


STREAMS = ["random", "ascending", "constant", "negatives",
           "nan in the warm-up", "nan after it", "inf, -0", "near FLT_MAX"]
# (N, C): N inside the third chunk, one past a boundary, on one, one
# before one, inside the first chunk, and past the shard
CHUNKINGS = [(N_SMALL, 5), (N_SMALL, 11), (N_SMALL, 12), (N_SMALL, 13),
             (N_SMALL, 64), (LANE + 39, 16)]


def _check(x, S, N, w, C):
    keep, (t0, counts, seen, cur) = ladder_chunks(
        torch.from_numpy(x).view(S, -1), N=N, w=w, C=C)
    for s, lane in enumerate(x.reshape(S, -1)):
        want = topn_det_prune(jnp.asarray(lane), N=N, w=w)
        np.testing.assert_array_equal(keep[s].numpy(), np.asarray(want.keep))
        np.testing.assert_array_equal(t0[s].numpy(),
                                      np.asarray(want.state.t0))
        np.testing.assert_array_equal(counts[s].numpy(),
                                      np.asarray(want.state.counts))
        assert int(seen[s]) == int(want.state.seen)
        assert int(cur[s]) == int(want.state.cur_level)


@pytest.mark.parametrize("N,C", CHUNKINGS)
@pytest.mark.parametrize("w", [1, 2, 8, 32])
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("name", STREAMS)
def test_chunked_ladder_matches_reference(name, S, w, N, C):
    _check(stream(name, S, LANE, seed=S * 100 + w), S, N, w, C)


@pytest.mark.parametrize("N", [100, 4095, 4096, 4097])
def test_chunked_ladder_kernel_chunks(N):
    """The kernel's own chunk of 4096 entries on a lane of three chunks and
    a few entries more, N inside the first chunk and at its end."""
    _check(stream("random", 1, 3 * 4096 + 5, seed=N), 1, N, 8, 4096)


def test_nan_min_keeps_the_first_of_equal_values():
    a = torch.tensor([-0.0, 0.0, 1.0, float("nan"), 2.0])
    b = torch.tensor([0.0, -0.0, float("nan"), 1.0, 2.0])
    got = nan_min(a, b)
    np.testing.assert_array_equal(np.signbit(got[:2].numpy()), [True, False])
    assert got[2].isnan() and got[3].isnan() and got[4] == 2.0
