"""The B = 1 designs of the SKYLINE and TOP-N pass-1 kernels, as short
pure-torch mirrors, bit for bit against the JAX package's scans.

SKYLINE (``csrc/skyline.cu``). For scores that are neither NaN nor <= NEG
the store after a prefix holds the prefix's first w entries in the order
(score descending, index ascending), so two stores merge. The kernel cuts a
lane into chunks and runs three phases:

1. summarize: each chunk's top-w candidates (score, point) among scores
   that are neither NaN nor <= NEG, and a flag when it holds a NaN score;
2. chain: the chunk summaries in order, each merged into the running store
   (each item ranked against the other list, compared as floats, the store
   first on ties); the store in force at each chunk's start is recorded, up
   to the lane's first chunk with a NaN flag;
3. replay: each chunk from its start store, ``THREADS`` entries a round:
   every open entry runs the engine step's test, the first with pos < w is
   inserted after the entries before it take their keep, and the round goes
   on after it. From the first NaN chunk on, the rest of the lane is
   replayed in order by the same rule.

At B > 1 the chunk is one block: NaN scores rank first and spend a round,
and the keep pass reads each block's start store with no replay.

TOP-N (``csrc/topn.cu``). An entry reads and writes only the row its
shard-local index hashes to. The kernel partitions each lane by (lane, row)
with the stable counting sort of ``csrc/rowpar.cuh`` (tile histograms of
the index hashes, one exclusive scan, stable ranks), then walks each
segment 32 entries at a time: the first entry whose value beats the row's
minimum is inserted, the entries before it keep iff value >= minimum, and
the step repeats after it.

The mirrors below are those designs on the CPU. They are held against
``repro.core.skyline_prune``, ``repro.core.topn_rand_prune`` and, for
SKYLINE at B > 1, ``repro.kernels.ref.skyline_block_ref``: keep and final
state, compared by their bits (so -0 and +0 differ), on adversarial
streams. This is the CPU evidence that the merge, the NaN rule and the
walk are exact; the CUDA kernels are held against the plain versions and
the retired serial kernels on the card (``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.kernels import ref as jref
from repro_torch.constants import NEG
from repro_torch.core.hashing import hash_mod
from repro_torch.core.skyline import score as skyline_score

THREADS = 4     # entries a replay round: several rounds a chunk
TILE = 16       # entries a partition tile
WARP = 32
NEGF = float(NEG)


def _bits(a):
    """f32 by its bits, every NaN as one: a NaN's sign and payload are not
    portable (XLA on x86 makes the APH of +inf 0xFFC00000, PyTorch's plain
    score 0x7FC00000, the card 0x7FFFFFFF)."""
    a = np.asarray(a)
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _eq(t, j):
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


# ================================================================== SKYLINE
def sky_summarize(h, x, chunk, w, per_entry):
    """Each chunk's candidate record (scores f32[w], points f32[w, D]; NEG
    and zero points past the candidates) and NaN flag. The stable
    descending sort ranks -0 and +0 equal and NaN first, as the kernel's
    keys do."""
    out = []
    for c0 in range(0, h.shape[0], chunk):
        hc, xc = h[c0:c0 + chunk], x[c0:c0 + chunk]
        order = torch.sort(hc, descending=True, stable=True).indices
        if per_entry:     # a NaN score takes no slot
            order = order[~hc[order].isnan()][:w]
        else:             # a NaN score is the block's best and spends a round
            order = order[:w]
        order = order[~hc[order].isnan() & (hc[order] > NEG)]
        sc = torch.full((w,), NEGF)
        pts = torch.zeros((w, x.shape[1]))
        sc[:len(order)], pts[:len(order)] = hc[order], xc[order]
        out.append((sc, pts, bool(hc.isnan().any()) and per_entry))
    return out


def sky_merge(st, cd, w):
    """First w of the stable merge of store and candidates, store first on
    ties: each item ranks itself against the other list."""
    (ss, sp), (cs, cp) = st, cd
    ns, npts = torch.full((w,), NEGF), torch.zeros_like(sp)
    for i in range(w):
        r = i + int((cs > ss[i]).sum())
        if r < w:
            ns[r], npts[r] = ss[i], sp[i]
        r = i + int((ss >= cs[i]).sum())
        if r < w:
            ns[r], npts[r] = cs[i], cp[i]
    return ns, npts


def sky_chain(cands, w, D):
    """(start store of each chunk up to the first NaN chunk, that chunk's
    number (len(cands) when none), the final store when no NaN)."""
    st = (torch.full((w,), NEGF), torch.zeros((w, D)))
    starts = []
    for c, (cs, cp, nan) in enumerate(cands):
        starts.append(st)
        if nan:
            return starts, c, None
        if cs[0] > st[0][-1]:
            st = sky_merge(st, (cs, cp), w)
    return starts, len(cands), st


def sky_replay(x, h, keep, st, lo, hi, w):
    """The engine step over [lo, hi) from store st, THREADS entries a round;
    returns the store after."""
    ss, sp = st[0].clone(), st[1].clone()
    idx = torch.arange(w)
    for t0 in range(lo, hi, THREADS):
        t1 = min(t0 + THREADS, hi)
        frm = t0
        while True:
            xs, hs = x[frm:t1], h[frm:t1]
            pos = (hs[:, None] <= ss).sum(1)
            dom = ((idx < pos[:, None]) & (xs[:, None] <= sp).all(-1)
                   & (xs[:, None] < sp).any(-1)).any(1)
            ins = torch.nonzero(pos < w).flatten()
            n = int(ins[0]) + 1 if len(ins) else t1 - frm
            keep[frm:frm + n] = ~dom[:n]
            if not len(ins):
                break
            j, p = int(ins[0]), int(pos[ins[0]])
            ss = torch.cat([ss[:p], hs[j:j + 1], ss[p:-1]])
            sp = torch.cat([sp[:p], xs[j:j + 1], sp[p:-1]])
            frm += j + 1
    return ss, sp


def skyline_mirror(lane, *, w, chunk, score, block=1, form="engine"):
    """keep bool[n] and the final (points, scores) of one lane."""
    x = lane.to(torch.float32)
    n, D = x.shape
    h = skyline_score(x, score, form)
    cands = sky_summarize(h, x, chunk, w, per_entry=block == 1)
    starts, f, final = sky_chain(cands, w, D)
    keep = torch.empty(n, dtype=torch.bool)
    if block > 1:
        for c, (ss, sp) in enumerate(starts):
            xc = x[c * chunk:(c + 1) * chunk, None]
            keep[c * chunk:(c + 1) * chunk] = ~(
                (xc <= sp).all(-1) & (xc < sp).any(-1) & (ss > NEG)).any(-1)
        return keep, final[1], final[0]
    for c in range(f):
        sky_replay(x, h, keep, starts[c], c * chunk, min(n, (c + 1) * chunk),
                   w)
    if f < len(cands):
        final = sky_replay(x, h, keep, starts[f], f * chunk, n, w)
    return keep, final[1], final[0]


SKY_STREAMS = [("random", "aph"), ("random", "sum"), ("ascending", "aph"),
               ("descending", "sum"), ("all equal", "aph"), ("zeros", "sum"),
               ("nan first", "sum"), ("nan mid", "aph"),
               ("nan at a chunk", "sum"), ("low", "sum")]
CHUNKS = [1, 7, 32, 64]
LANE = {1: 150, 8: 24}


def sky_points(name, m, chunk):
    """[m, 2] points. Coordinates stay below 2000, where the port's APH and
    XLA's agree bit for bit; an APH coordinate of +inf or a SUM coordinate
    of NaN scores NaN in both packages."""
    rng = np.random.default_rng(len(name) * 31 + m)
    x = rng.uniform(0, 2000, (m, 2)).astype(np.float32)
    x[::9, 1] = rng.uniform(0, 1, x[::9].shape[0])       # APH's -16 arm
    i = np.arange(m, dtype=np.float32)
    if name == "ascending":         # every entry inserts
        x = np.stack([i + 1, i + 1], 1)
    elif name == "descending":
        x = np.stack([m - i, m - i], 1)
    elif name == "all equal":
        x = np.full((m, 2), 5.0, np.float32)
    elif name == "zeros":           # +-0 scores tie and rank by index
        x = rng.choice(np.array([0.0, -0.0], np.float32), (m, 2))
        x[::5] = -1.0
        x[::7, 0] = 1.0
    elif name.startswith("nan"):
        at = {"nan first": 0, "nan mid": m // 2,
              "nan at a chunk": min(m - 1, 2 * chunk)}[name]
        x[at, at % 2] = np.inf if name == "nan mid" else np.nan
    elif name == "low":             # SUM scores <= NEG, and just above it
        x[::3] = (-3e38, -5e37)
        x[1::5, 0] = -np.inf
        x[2::7] = (-3e38, 0.0)
    return x.astype(np.float32)


_skyline_block = jax.jit(jref.skyline_block_ref,
                         static_argnames=("w", "block", "score",
                                          "return_state"))


@functools.lru_cache(maxsize=None)
def _jax_scan(name, shards, w, score, nan_chunk):
    pts = sky_points(name, shards * LANE[shards], nan_chunk)
    out = []
    for lane in pts.reshape(shards, -1, 2):
        r = J.skyline_prune(jnp.asarray(lane), w=w, score=score)
        out.append(tuple(np.asarray(a) for a in (r.keep, r.state.points,
                                                 r.state.scores)))
    return pts, out


@pytest.mark.parametrize("w", [1, 8, 33])
@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name,score", SKY_STREAMS)
def test_skyline_phases_match_the_engine_scan(name, score, chunk, shards, w):
    pts, want = _jax_scan(name, shards, w, score,
                          chunk if name == "nan at a chunk" else 0)
    lanes = torch.from_numpy(pts).reshape(shards, -1, 2)
    for s in range(shards):
        keep, p, sc = skyline_mirror(lanes[s], w=w, chunk=chunk, score=score)
        _eq(keep, want[s][0])
        _eq(p, want[s][1])
        _eq(sc, want[s][2])


@pytest.mark.parametrize("w", [1, 8, 33])
@pytest.mark.parametrize("block", [7, 32])
@pytest.mark.parametrize("name,score", SKY_STREAMS)
def test_skyline_block_form_matches_block_ref(name, score, block, w):
    """B > 1: phases 1 and 2 with a chunk of one block, then one keep pass
    against each block's start store; NaN scores spend rounds."""
    pts = sky_points(name, 160, block if name == "nan at a chunk" else 0)
    keep, (P, S) = _skyline_block(jnp.asarray(pts), w=w, block=block,
                                  score=score, return_state=True)
    n = pts.shape[0] // block * block
    k, p, sc = skyline_mirror(torch.from_numpy(pts[:n]), w=w, chunk=block,
                              score=score, block=block)
    _eq(k.to(torch.int32), keep)
    _eq(p, P)
    _eq(sc, S)


@pytest.mark.parametrize("D", [1, 2, 3])
def test_sum_score_of_negative_zeros_matches_xla(D):
    """XLA sums from an init of +0, so a SUM score of D >= 2 coordinates
    that are all -0 is +0 (stored in the state as such), and a one-element
    sum is the element. The port's plain score and the CUDA kernels add
    the +0."""
    from repro.kernels import skyline_prune as jsk

    x = np.array([[-0.0] * D, [0.0] * D, [-0.0] + [0.0] * (D - 1),
                  [1.0] + [-1.0] * (D - 1), [-3e38] * D], np.float32)
    want = J.score_sum(jnp.asarray(x))
    _eq(skyline_score(torch.from_numpy(x), "sum"), want)
    _eq(skyline_score(torch.from_numpy(x), "sum"),
        jsk._score(jnp.asarray(x), "sum"))


def test_skyline_merge_is_the_sequential_store():
    """The chain's stores are the engine scan's stores at every chunk start
    of a NaN-free stream (the invariant the merge rests on), ties of +-0
    included."""
    x = torch.from_numpy(sky_points("zeros", 60, 0))
    h = skyline_score(x, "sum")
    starts, f, final = sky_chain(sky_summarize(h, x, 12, 4, True), 4, 2)
    assert f == len(starts) == 5
    for c in range(f):
        r = J.skyline_prune(jnp.asarray(x[:c * 12].numpy()), w=4,
                            score="sum")
        _eq(starts[c][0], r.state.scores)
        _eq(starts[c][1], r.state.points)


# ==================================================================== TOP-N
def index_partition(n, shards, d, seed):
    """(order int64[m], starts int64[S*d + 1]) of the stable partition by
    (lane, hash_mod(shard-local index)): tile histograms, one exclusive
    scan over (segment, tile), stable ranks within each tile."""
    m = shards * n
    tpl = -(-n // TILE)
    idx = torch.arange(m)
    lane, local = idx // n, idx % n
    seg = lane * d + hash_mod(local, d, seed)
    cell = seg * tpl + local // TILE
    counts = torch.zeros(shards * d * tpl, dtype=torch.int64)
    counts.index_add_(0, cell, torch.ones(m, dtype=torch.int64))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.zeros(m, dtype=torch.int64)
    seen = {}
    for i, c in enumerate(cell.tolist()):
        rank[i] = seen.get(c, 0)
        seen[c] = rank[i] + 1
    order = torch.empty(m, dtype=torch.int64)
    order[offsets[cell] + rank] = idx
    starts = torch.cat([offsets[::tpl], torch.tensor([m])])
    return order, starts


def topn_mirror(values, *, d, w, seed, shards):
    """keep bool[m] and the final matrices f32[S, d, w]."""
    m = values.shape[0]
    order, starts = index_partition(m // shards, shards, d, seed)
    v = values.to(torch.float32)
    keep = torch.zeros(m, dtype=torch.bool)
    states = torch.full((shards * d, w), NEGF)
    for g in range(shards * d):
        row = [NEGF] * w                   # f32 values held exactly
        seg = order[starts[g]:starts[g + 1]].tolist()
        for c0 in range(0, len(seg), WARP):
            ids = seg[c0:c0 + WARP]
            vs = [float(v[i]) for i in ids]
            done = 0
            while True:                    # one ballot a step
                first = next((i for i in range(done, len(ids))
                              if vs[i] > row[-1]), len(ids))
                for i in range(done, first):
                    keep[ids[i]] = vs[i] >= row[-1]
                if first == len(ids):
                    break
                pos = sum(vs[first] <= r for r in row)
                row = row[:pos] + [vs[first]] + row[pos:-1]
                keep[ids[first]] = True
                done = first + 1
        states[g] = torch.tensor(row, dtype=torch.float32)
    return keep, states.reshape(shards, d, w)


TOPN_STREAMS = ["random", "ascending", "descending", "all equal", "zeros",
                "nan first", "nan mid", "low"]


def topn_values(name, m):
    rng = np.random.default_rng(len(name) + m)
    x = (rng.random(m) * 1000).astype(np.float32)
    i = np.arange(m, dtype=np.float32)
    if name == "ascending":
        x = i
    elif name == "descending":
        x = -i
    elif name == "all equal":
        x = np.full(m, 3.0, np.float32)
    elif name == "zeros":           # the row keeps the first-come bits
        x = rng.choice(np.array([0.0, -0.0, -1.0], np.float32), m)
    elif name == "nan first":
        x[0] = np.nan
        x[5::40] = np.nan
    elif name == "nan mid":
        x[m // 2:m // 2 + 9] = np.nan
    elif name == "low":             # never stored: -inf and NEG itself
        x[::3] = -np.inf
        x[1::4] = NEG
        x[2::5] = -3e38
    return x.astype(np.float32)


@pytest.mark.parametrize("d,w", [(1, 1), (1, 8), (1, 33), (37, 1), (37, 8),
                                 (37, 33), (512, 1), (512, 8), (512, 33)])
@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("name", TOPN_STREAMS)
def test_topn_walk_matches_the_engine_scan(name, shards, d, w):
    x = topn_values(name, 480)
    keep, states = topn_mirror(torch.from_numpy(x), d=d, w=w, seed=shards,
                               shards=shards)
    for s, lane in enumerate(x.reshape(shards, -1)):
        r = J.topn_rand_prune(jnp.asarray(lane), d=d, w=w, seed=shards)
        _eq(keep.reshape(shards, -1)[s], r.keep)
        _eq(states[s], r.state.vals)


@pytest.mark.parametrize("shards", [1, 8])
def test_index_partition_is_stable_by_segment(shards):
    """Each segment holds its lane's entries of one row, in stream order,
    and the segments cover the stream once."""
    d, n = 37, 200
    order, starts = index_partition(n, shards, d, seed=5)
    assert sorted(order.tolist()) == list(range(shards * n))
    rows = hash_mod(torch.arange(n), d, 5)
    for g in range(shards * d):
        seg = order[starts[g]:starts[g + 1]]
        assert torch.all(seg[1:] > seg[:-1])
        assert torch.all(seg // n == g // d)
        assert torch.all(rows[seg % n] == g % d)
