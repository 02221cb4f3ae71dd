"""The row-parallel design of the DISTINCT and GROUP BY pass-1 kernels, as a
short pure-torch mirror, bit for bit against the JAX package's scans.

An entry reads and writes only the cache row its key hashes to, so a lane
is d independent chains. ``csrc/distinct.cu`` and ``csrc/groupby.cu`` walk
them apart:

1. partition: tiles of ``TILE`` entries of one lane each count their rows,
   an exclusive scan over the (lane, row, tile) count matrix gives each
   tile's offset in each segment (lane, row), and a stable scatter puts
   every entry there, in stream order within its segment;
2. collapse (DISTINCT): an entry whose segment predecessor has the same key
   and that can hit (``ref.distinct_keys``) is a no-op, keep False; the
   others are compacted;
3. walk: each segment in order, from the empty row, 32 entries at a time
   as a warp loads them. GROUP BY folds a run of one key (an entry whose
   predecessor in the segment is valid with the same key) without a probe,
   and writes each run entry's emission of the row's last slot, which is
   the running aggregate when the key sits in that slot.

The mirror below is that design on the CPU. It is held against
``repro.core.distinct_prune`` (FIFO and LRU) and
``repro.core.groupby_prune`` on adversarial streams and a zipf(1.3)
stream: keep, emissions and final state, bit for bit. This is the CPU
evidence that row independence and the collapse are exact; the kernels are
held against the plain versions and the retired serial kernels on the card
(``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro_torch.core.hashing import hash_mod
from repro_torch.kernels.groupby_scan import INIT, fold
from repro_torch.kernels.ref import distinct_keys

TILE = 64
WARP = 32


def partition(x, shards, d, seed):
    """(order int64[m], starts int64[S*d + 1]): entry order[j] is the j-th
    of the partitioned stream; segment g = lane * d + row holds
    [starts[g], starts[g+1]). Tile histograms, one exclusive scan over
    (segment, tile) and a stable rank within each tile, as the kernels
    compute them."""
    m = x.shape[0]
    n = m // shards
    tpl = -(-n // TILE)
    rows = hash_mod(x, d, seed)
    idx = torch.arange(m)
    lane, local = idx // n, idx % n
    seg = lane * d + rows
    col = local // TILE
    counts = torch.zeros(shards * d * tpl, dtype=torch.int64)
    counts.index_add_(0, seg * tpl + col, torch.ones(m, dtype=torch.int64))
    offsets = torch.cumsum(counts, 0) - counts
    # rank of an entry among the earlier entries of its (segment, tile)
    cell = seg * tpl + col
    rank = torch.zeros(m, dtype=torch.int64)
    seen = {}
    for i, c in enumerate(cell.tolist()):
        rank[i] = seen.get(c, 0)
        seen[c] = rank[i] + 1
    order = torch.empty(m, dtype=torch.int64)
    order[offsets[cell] + rank] = idx
    starts = torch.cat([offsets[::tpl], torch.tensor([m])])
    return order, starts


def distinct_mirror(x, *, d, w, policy, seed=0, shards=1):
    m = x.shape[0]
    key, hittable = distinct_keys(x)
    order, starts = partition(x, shards, d, seed)
    keep = torch.zeros(m, dtype=torch.bool)
    # collapse: same segment and key as the predecessor, and able to hit
    pkey, phit = key[order], hittable[order]
    seg_of = torch.repeat_interleave(torch.arange(shards * d),
                                     starts[1:] - starts[:-1])
    dup = torch.zeros(m, dtype=torch.bool)
    dup[1:] = ((seg_of[1:] == seg_of[:-1]) & (pkey[1:] == pkey[:-1])
               & phit[1:])
    survivors = torch.nonzero(~dup).flatten()
    cstarts = torch.searchsorted(survivors, starts)
    slots = torch.zeros((shards * d, w), dtype=torch.int64)
    valid = torch.zeros((shards * d, w), dtype=torch.bool)
    head = torch.zeros(shards * d, dtype=torch.int32)
    for g in range(shards * d):
        s, v, h = [0] * w, [False] * w, 0
        for j in survivors[cstarts[g]:cstarts[g + 1]].tolist():
            k, ok = int(pkey[j]), bool(phit[j])
            pos = next((i for i in range(w) if v[i] and s[i] == k and ok), w)
            keep[order[j]] = pos == w
            if policy == "lru":
                lim = pos if pos < w else w - 1
                s[1:lim + 1], v[1:lim + 1] = s[:lim], v[:lim]
                s[0], v[0] = k, True
            elif pos == w:
                s[h], v[h], h = k, True, (h + 1) % w
        slots[g], valid[g], head[g] = torch.tensor(s), torch.tensor(v), h
    return (keep, slots.reshape(shards, d, w).to(torch.uint32),
            valid.reshape(shards, d, w), head.reshape(shards, d))


def groupby_mirror(keys, vals, ok, *, d, w, agg, seed=0, shards=1):
    m = keys.shape[0]
    order, starts = partition(keys, shards, d, seed)
    k64 = keys.to(torch.int64) & 0xFFFFFFFF
    ev_k = torch.zeros(m, dtype=torch.int64)
    ev_a = torch.zeros(m, dtype=torch.float32)
    ev_v = torch.zeros(m, dtype=torch.bool)
    init = torch.tensor(INIT[agg], dtype=torch.float32)
    st_k = torch.zeros((shards * d, w), dtype=torch.int64)
    st_a = torch.full((shards * d, w), float(INIT[agg]), dtype=torch.float32)
    st_v = torch.zeros((shards * d, w), dtype=torch.bool)
    for g in range(shards * d):
        ks, a, v = [0] * w, [init.clone() for _ in range(w)], [False] * w
        seg = order[starts[g]:starts[g + 1]].tolist()
        last_slot, prev = 0, None          # prev: (key, valid) before
        for c in range(0, len(seg), WARP):  # one warp-load of entries
            for i in seg[c:c + WARP]:
                kk, vv, oo = int(k64[i]), vals[i], bool(ok[i])
                run = oo and prev is not None and prev == (kk, True)
                ev_k[i], ev_a[i] = ks[w - 1], a[w - 1]
                if run:                    # a hit at last_slot, no probe
                    a[last_slot] = fold(agg, a[last_slot], vv)
                else:
                    pos = next((j for j in range(w) if v[j] and ks[j] == kk),
                               w)
                    ev_v[i] = v[w - 1] and pos == w and oo
                    if oo and pos < w:
                        a[pos] = fold(agg, a[pos], vv)
                        last_slot = pos
                    elif oo:
                        ks, a, v = ([kk] + ks[:-1],
                                    [fold(agg, init, vv)] + a[:-1],
                                    [True] + v[:-1])
                        last_slot = 0
                prev = (kk, oo)
        st_k[g], st_a[g], st_v[g] = (torch.tensor(ks), torch.stack(a),
                                     torch.tensor(v))
    shape = (shards, d, w)
    return ((ev_k.to(torch.uint32), ev_a, ev_v),
            (st_k.reshape(shape).to(torch.uint32), st_a.reshape(shape),
             st_v.reshape(shape)))


def _zipf(rng, m):
    return (rng.zipf(1.3, m) % 5000).astype(np.uint32)


def streams(name, rng, m=1500):
    """The adversarial inputs the kernels are held to on the card."""
    if name == "zipf":
        return _zipf(rng, m)
    if name == "hot key":       # one key is 90 % of the stream
        x = rng.integers(0, 300, m).astype(np.uint32)
        x[rng.random(m) < 0.9] = 7
        return x
    if name == "one row":       # every key hashes to one row (d = 1)
        return rng.integers(0, 9, m).astype(np.uint32)
    if name == "alternating":   # two keys alternating in one row
        return np.where(np.arange(m) % 2 == 0, 3, 11).astype(np.uint32)
    raise KeyError(name)


# the last case has rows of more than 32 slots, which the kernels walk in
# shared memory rather than in registers
CASES = [("zipf", 64, 4), ("hot key", 16, 4), ("one row", 1, 4),
         ("alternating", 1, 2), ("zipf", 37, 3), ("zipf", 70000, 2),
         ("zipf", 2, 40)]


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("name,d,w", CASES)
def test_distinct_walk_matches_reference(policy, name, d, w):
    x = streams(name, np.random.default_rng(d * 7 + w))
    want = J.distinct_prune(jnp.asarray(x), d=d, w=w, policy=policy, seed=3)
    keep, slots, valid, head = distinct_mirror(
        torch.from_numpy(x), d=d, w=w, policy=policy, seed=3)
    _eq(keep, want.keep)
    _eq(slots[0], want.state.slots)
    _eq(valid[0], want.state.valid)
    _eq(head[0], want.state.head)


@pytest.mark.parametrize("policy", ["lru", "fifo"])
def test_distinct_walk_float_keys_match_reference(policy):
    """f32 streams: repeats of non-integers never collapse (they cannot
    hit), integers do."""
    rng = np.random.default_rng(5)
    x = rng.choice(np.array([4.5, 4.0, -1.0, 7.0, np.nan, 2.0 ** 32, 0.0,
                             -0.0], np.float32), 900)
    want = J.distinct_prune(jnp.asarray(x), d=4, w=2, policy=policy)
    keep, slots, valid, head = distinct_mirror(torch.from_numpy(x), d=4,
                                               w=2, policy=policy)
    _eq(keep, want.keep)
    _eq(slots[0], want.state.slots)


@pytest.mark.parametrize("shards", [1, 8])
def test_distinct_walk_lanes_are_independent(shards):
    x = streams("zipf", np.random.default_rng(9), m=2048)
    lanes = x.reshape(shards, -1)
    keep, slots, _, _ = distinct_mirror(torch.from_numpy(x), d=32, w=4,
                                        policy="lru", shards=shards)
    for s in range(shards):
        want = J.distinct_prune(jnp.asarray(lanes[s]), d=32, w=4)
        _eq(keep.reshape(shards, -1)[s], want.keep)
        _eq(slots[s], want.state.slots)


def _values(rng, m):
    v = rng.normal(size=m).astype(np.float32) * 100
    v[rng.random(m) < 0.02] = np.nan
    return v


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("name,d,w", CASES[:5] + CASES[6:])
def test_groupby_walk_matches_reference(agg, name, d, w):
    rng = np.random.default_rng(d * 11 + w)
    keys = streams(name, rng)
    vals = _values(rng, keys.shape[0])
    ok = rng.random(keys.shape[0]) < 0.95   # invalid (padding) entries
    want = J.groupby_prune(jnp.asarray(keys), jnp.asarray(vals),
                           jnp.asarray(ok), d=d, w=w, agg=agg, seed=1)
    (ek, ea, ev), st = groupby_mirror(
        torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(ok),
        d=d, w=w, agg=agg, seed=1)
    for got, exp in zip((ek, ea, ev), want.emitted):
        _eq(got, exp)
    for got, f in zip(st, ("keys", "aggs", "valid")):
        _eq(got[0], getattr(want.state, f))


@pytest.mark.parametrize("agg", ["sum", "count"])
def test_groupby_walk_hot_key_in_the_last_slot(agg):
    """w = 1: the hot key always sits in the last slot, so every run entry
    emits the running aggregate (with ev_valid False): the trap of
    dropping run entries from the walk."""
    rng = np.random.default_rng(2)
    keys = np.where(rng.random(800) < 0.8, 5, rng.integers(0, 40, 800))
    keys = keys.astype(np.uint32)
    vals = _values(rng, 800)
    want = J.groupby_prune(jnp.asarray(keys), jnp.asarray(vals), d=2, w=1,
                           agg=agg)
    (ek, ea, ev), st = groupby_mirror(
        torch.from_numpy(keys), torch.from_numpy(vals),
        torch.ones(800, dtype=torch.bool), d=2, w=1, agg=agg)
    _eq(ea, want.emitted[1])
    _eq(ev, want.emitted[2])
    _eq(st[1][0], want.state.aggs)


@pytest.mark.parametrize("slot_bytes", [5, 9])
def test_walks_take_any_row_that_fits_shared_memory(slot_bytes):
    """The walks keep a row of up to 32 slots in registers and a wider one
    in shared memory (5 bytes a DISTINCT slot, 9 a GROUP BY slot): every w
    up to what 227 KB hold is taken, and the first w past it is refused
    with a ValueError, as is an entry index past int32."""
    from repro_torch.kernels.common import MAX_SMEM, check_rowpar

    widest = MAX_SMEM // slot_bytes
    for w in (1, 32, 33, 64, 4096, widest):
        check_rowpar(1 << 20, w, slot_bytes)
    with pytest.raises(ValueError, match="shared memory"):
        check_rowpar(1 << 20, widest + 1, slot_bytes)
    with pytest.raises(ValueError, match="int32"):
        check_rowpar(1 << 31, 4, slot_bytes)
