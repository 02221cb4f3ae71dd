"""The chunked run scan of the ``rle_topn_det`` kernel, as a short pure-torch
mirror, bit for bit against the JAX package's scan and Pallas kernel.

Per run (v, L) the threshold ladder has a closed form (``kernels/rle_scan.py``)
whose state is three chained prefix computations: seen (a sum of the
lengths), t0 (a minimum of the values of the warm runs, seen < N) and the
level counts (a sum of L * ge per level, ge = v >= t0 * 2^i). The sums are
int32 and wrap past 2^31, so the warm runs are not a prefix of the runs
(ROADMAP Queue 3 A10). ``csrc/topn_det.cu`` cuts the runs into chunks of C
and runs on every chunk at once:

1. each chunk's length sum, then an exclusive sum-scan over the chunks
   gives each chunk its entering seen, and each run its seen_start;
2. each chunk's minimum of its warm candidates (seen_start < N ? v : POS),
   over every chunk, then an exclusive min-scan in stream order gives each
   chunk its entering t0;
3. each chunk's per-level sums of L * ge, ge against each run's running t0,
   then an exclusive sum-scan per level gives each chunk its entering
   counts;
4. a replay of each chunk from its entering state writes head and tstar,
   A and C from the whole ge vector.

The mirror below is that design on the CPU, its sums wrapped to int32. Chunk
sizes of 4, 8 and 64 runs make a small stream span many chunks. It is held
against ``repro.kernels.rle_scan.rle_topn_det_ref`` (a ``lax.scan`` a run)
and ``repro.kernels.ops.rle_topn_prune`` (the Pallas kernel in interpret
mode) on numpy-seeded streams. This is the CPU evidence that the chunked
scan is exact; the kernel runs only on the card, where ``chip_smoke.py``
holds it against the plain version and the one-CTA kernel it replaced.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import rle_scan as jrle
from repro_torch.constants import POS

R_RUNS = 150
BIG = 1 << 30
FLT_MAX = np.finfo(np.float32).max
NNAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
PNAN = np.array([0x7FC00000], np.uint32).view(np.float32)[0]


def i32(x):
    """int64 values wrapped as int32 arithmetic wraps them."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def nan_min(a, b):
    """jnp.minimum with ``a`` the earlier operand: a NaN wins, and of equal
    values the earlier stays."""
    return torch.where(a.isnan(), a, torch.where(b.isnan() | (b < a), b, a))


def exscan(x, op, ident):
    """Exclusive scan over dim 0 in order, from ``ident``."""
    out = torch.empty_like(x)
    run = ident.expand_as(x[0]).clone()
    for k in range(x.shape[0]):
        out[k] = run
        run = op(run, x[k])
    return out


def rle_chunks(v, L, *, N, w, C):
    """(head int32[R], tstar int32[R]) by the chunked scan in chunks of C."""
    R = v.shape[0]
    K = -(-R // C)
    pos = torch.tensor(float(POS))
    vp = torch.cat([v, pos.expand(K * C - R)]).view(K, C)
    Lp = torch.cat([i32(L.to(torch.int64)),
                    torch.zeros(K * C - R, dtype=torch.int64)]).view(K, C)
    add = lambda a, b: i32(a + b)                     # noqa: E731
    zero = torch.zeros((), dtype=torch.int64)
    # 1. chunk length sums, their exclusive scan, each run's seen_start
    seen_in = exscan(i32(Lp.sum(1)), add, zero)
    ss = i32(seen_in[:, None] + torch.cumsum(Lp, 1) - Lp)
    # 2. chunk minima of the warm candidates over every chunk, their
    # exclusive min-scan, each run's running t0
    warm = ss < N
    cmin = pos.expand(K).clone()
    for c in range(C):
        cmin = torch.where(warm[:, c], nan_min(cmin, vp[:, c]), cmin)
    run = exscan(cmin, nan_min, pos)
    t0 = torch.empty(K, C)
    for c in range(C):
        run = torch.where(warm[:, c], nan_min(run, vp[:, c]), run)
        t0[:, c] = run
    # 3. per (chunk, level) sums of L * ge, their exclusive scan per level
    p2 = torch.tensor([2.0 ** i for i in range(w)], dtype=torch.float32)
    ge = vp[..., None] >= t0[..., None] * p2                  # [K, C, w]
    dL = Lp[..., None] * ge
    counts_in = exscan(i32(dL.sum(1)), add, torch.zeros(w, dtype=torch.int64))
    # 4. replay: each run's entering counts, A, C, head and tstar
    cin = i32(counts_in[:, None, :] + torch.cumsum(dL, 1) - dL)
    levels = torch.arange(w)
    A = torch.where(~ge & (cin >= N), levels, -1).amax(-1)
    Cmax = torch.where(ge & (levels > A[..., None]), cin, -1).amax(-1)
    head = torch.minimum(i32(N - ss).clamp(min=0), Lp)
    tstar = torch.where(A < 0, 1, torch.where(Cmax >= 0, i32(N - Cmax), BIG))
    return (head.reshape(-1)[:R].to(torch.int32),
            tstar.reshape(-1)[:R].to(torch.int32))


def stream(name, seed):
    """(f32 values, int32 lengths) of R_RUNS runs."""
    rng = np.random.default_rng(seed)
    v = rng.gamma(2.0, 20.0, R_RUNS).astype(np.float32)
    L = rng.integers(1, 20, R_RUNS).astype(np.int32)
    if name == "unit lengths":        # N sets where the warm-up ends
        L[:] = 1
    elif name == "zero-length runs":  # inside the column and as pads
        L[rng.random(R_RUNS) < 0.25] = 0
        v[-9:], L[-9:] = POS, 0
    elif name == "negatives":         # t0 <= 0: the C branch
        v -= 45.0
    elif name == "nan, +-0, +-inf, near FLT_MAX":
        pool = np.array([NNAN, PNAN, 0.0, -0.0, np.inf, -np.inf, FLT_MAX,
                         np.nextafter(FLT_MAX, 0), 3.0e38, -FLT_MAX],
                        np.float32)
        at = rng.random(R_RUNS) < 0.2
        v[at] = rng.choice(pool, int(at.sum()))
    elif name == "near FLT_MAX":      # t0 stays POS; levels overflow to inf
        v = (rng.random(R_RUNS) * 2.4e38 + 1e38).astype(np.float32)
        v[::4] = FLT_MAX
    elif name == "wrap":              # warm runs are not a prefix
        L[[3, 4, 5, 40, 41, 42, 43, 90]] = BIG + rng.integers(-99, 99, 8)
    elif name != "random":
        raise KeyError(name)
    return v, L


# (stream, N as a function of the chunk size C and the stream's rows)
CASES = [
    ("random", lambda C, rows: 250),
    ("random", lambda C, rows: 1),
    ("random", lambda C, rows: rows + 7),              # N above the rows
    ("unit lengths", lambda C, rows: 3 * C),           # ends at a boundary
    ("unit lengths", lambda C, rows: 3 * C + C // 2 + 1),  # ends mid-chunk
    ("zero-length runs", lambda C, rows: 60),
    ("negatives", lambda C, rows: 40),
    ("nan, +-0, +-inf, near FLT_MAX", lambda C, rows: 50),
    ("near FLT_MAX", lambda C, rows: 30),
    ("wrap", lambda C, rows: 100),
]
IDS = ["random", "N=1", "N>rows", "warm ends at a boundary",
       "warm ends mid-chunk", "zero-length runs", "negatives", "specials",
       "near FLT_MAX", "wrap"]


@lru_cache(maxsize=None)
def reference(case, N, w):
    """(head, tstar) of the JAX scan, checked equal to the Pallas kernel's."""
    v, L = stream(CASES[case][0], seed=case)
    jv, jL = jnp.asarray(v), jnp.asarray(L)
    want = [np.asarray(a) for a in jrle.rle_topn_det_ref(jv, jL, N=N, w=w)]
    for a, b in zip(jops.rle_topn_prune(jv, jL, N=N, w=w, block=64), want):
        np.testing.assert_array_equal(np.asarray(a), b)
    return want


@pytest.mark.parametrize("C", [4, 8, 64])
@pytest.mark.parametrize("w", [1, 4, 32])
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_chunked_run_scan_matches_reference(case, w, C):
    name, n_of = CASES[case]
    v, L = stream(name, seed=case)
    rows = int(L.astype(np.int64).sum())
    N = n_of(C, rows)
    head, tstar = rle_chunks(torch.from_numpy(v), torch.from_numpy(L), N=N,
                             w=w, C=C)
    want_head, want_tstar = reference(case, N, w)
    np.testing.assert_array_equal(head.numpy(), want_head)
    np.testing.assert_array_equal(tstar.numpy(), want_tstar)


def test_wrap_stream_rewarms_after_the_wrap():
    """The wrap stream is what it claims: some run after a non-warm run is
    warm again, because seen wrapped negative."""
    _, L = stream("wrap", seed=len(CASES) - 1)
    ss = i32(torch.cumsum(torch.from_numpy(L).to(torch.int64), 0)
             - torch.from_numpy(L))
    warm = (ss < 100).numpy()
    first_cold = int(np.argmin(warm))
    assert not warm[first_cold] and warm[first_cold:].any()


def test_kernel_chunk_on_several_chunks():
    """The kernel's own chunk of 2048 runs on a stream of three chunks and a
    few runs more, the warm-up ending inside the second chunk."""
    rng = np.random.default_rng(5)
    R = 3 * 2048 + 37
    v = rng.gamma(2.0, 20.0, R).astype(np.float32)
    L = np.ones(R, np.int32)
    N = 2048 + 300
    head, tstar = rle_chunks(torch.from_numpy(v), torch.from_numpy(L), N=N,
                             w=8, C=2048)
    want = jrle.rle_topn_det_ref(jnp.asarray(v), jnp.asarray(L), N=N, w=8)
    np.testing.assert_array_equal(head.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tstar.numpy(), np.asarray(want[1]))
