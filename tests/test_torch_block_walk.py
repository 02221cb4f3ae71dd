"""The row-parallel block walk of DISTINCT's pass 1 at B > 1, as a short
pure-torch mirror, bit for bit against the JAX package's block oracle and
its Pallas kernel.

Under block semantics (``repro.kernels.ref``) an entry is kept when it
misses its row as the row stood before its block of B entries, and of each
(row, block) only the first miss inserts, at head[row]. An entry still
reads and writes only its own row, so ``csrc/distinct.cu`` walks each
(lane, row) on its own:

1. partition: a stable sort of the stream by (lane, row), stream order
   kept within each segment, so that a segment's entries of one block are
   contiguous;
2. collapse: an entry whose segment predecessor has the same key, the same
   hit rule and the same block is dropped from the walk: it hits or misses
   with its predecessor and is never its group's first miss. A repeat from
   an earlier block is not dropped: that block may have inserted over the
   slot it would hit (``TRAP``);
3. walk: windows of 32 entries from the first unresolved one. Every entry
   is probed against the row as it stands, except that an entry of the
   group that inserted last sees the slot that insert overwrote as it was;
   the first miss of a later group inserts at head, and every entry up to
   the end of its group in the window is resolved;
4. fill: a dropped repeat takes the keep of the entry it repeats.

The mirror below is that design on the CPU, held against
``repro.kernels.ref.distinct_block_ref`` (keep and the final slots, valid
flags and heads) and ``repro.kernels.distinct_prune.distinct_prune_kernel``
in interpret mode (keep), on uint32 streams; float32 keys against the
port's own ``ref.distinct_block_ref``, because the JAX block kernels refuse
them (ROADMAP Queue 3 A3). The kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version and the block kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.distinct_prune import distinct_prune_kernel
from repro_torch.core.hashing import hash_mod
from repro_torch.kernels import parallel as tpar
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ref import distinct_keys

WARP = 32
SEED = 3
# d = 1, w = 1, B = 2: entry 4 repeats entry 3, but entry 3's block
# inserted 9 over the 7 that entry 3 hit, so entry 4 misses
TRAP = (np.array([7, 7, 9, 7, 7, 11], np.uint32), [1, 1, 1, 0, 1, 1])


def walk_segment(keys, blocks, hittable, w):
    """The walk of one segment's compacted entries: (keep, slots, valid,
    head)."""
    s, v, h = [0] * w, [False] * w, 0
    g_ins, h_ins, k_ins, v_ins = None, 0, 0, False
    keep = [False] * len(keys)
    rel = 0
    while rel < len(keys):
        win = range(rel, min(rel + WARP, len(keys)))
        hit = {}
        for e in win:
            skip = h_ins if blocks[e] == g_ins else -1
            hit[e] = hittable[e] and (
                any(v[i] and s[i] == keys[e] for i in range(w) if i != skip)
                or (skip >= 0 and v_ins and k_ins == keys[e]))
        cand = [e for e in win if blocks[e] != g_ins and not hit[e]]
        n = len(win)
        if cand:
            gf = blocks[cand[0]]
            n = sum(blocks[e] <= gf for e in win)
            h_ins, k_ins, v_ins = h, s[h], v[h]
            s[h], v[h], h = keys[cand[0]], True, (h + 1) % w
            g_ins = gf
        for e in win[:n]:
            keep[e] = not hit[e]
        rel += n
    return keep, s, v, h


def block_walk(x, *, d, w, block, seed=SEED, shards=1):
    """The block walk over S lanes of x [m]: (keep bool[m], slots
    uint32[S, d, w], valid bool[S, d, w], head int32[S, d])."""
    m = x.shape[0]
    n = m // shards
    key, hittable = distinct_keys(x)
    idx = torch.arange(m)
    seg = (idx // n) * d + hash_mod(x, d, seed)
    blk = (idx % n) // block
    # 1. partition
    order = torch.sort(seg, stable=True).indices
    pk, ph, pb, ps = key[order], hittable[order], blk[order], seg[order]
    # 2. collapse
    dup = torch.zeros(m, dtype=torch.bool)
    dup[1:] = ((ps[1:] == ps[:-1]) & (pk[1:] == pk[:-1]) & (ph[1:] == ph[:-1])
               & (pb[1:] == pb[:-1]))
    walked = torch.nonzero(~dup).flatten()
    cstarts = torch.searchsorted(ps[walked], torch.arange(shards * d + 1))
    # 3. walk
    ckeep = torch.zeros(walked.numel(), dtype=torch.bool)
    slots = torch.zeros((shards * d, w), dtype=torch.int64)
    valid = torch.zeros((shards * d, w), dtype=torch.bool)
    head = torch.zeros(shards * d, dtype=torch.int32)
    for g in range(shards * d):
        lo, hi = int(cstarts[g]), int(cstarts[g + 1])
        sel = walked[lo:hi]
        kp, s, v, h = walk_segment(pk[sel].tolist(), pb[sel].tolist(),
                                   ph[sel].tolist(), w)
        ckeep[lo:hi] = torch.tensor(kp, dtype=torch.bool)
        slots[g], valid[g], head[g] = torch.tensor(s), torch.tensor(v), h
    # 4. fill: the last walked entry at or before each entry
    keep = torch.empty(m, dtype=torch.bool)
    keep[order] = ckeep[torch.cumsum(~dup, 0) - 1]
    shape = (shards, d, w)
    return (keep, slots.reshape(shape).to(torch.uint32), valid.reshape(shape),
            head.reshape(shards, d))


def stream(name, m, rng):
    if name == "zipf":
        return (rng.zipf(1.3, m) % 500).astype(np.uint32)
    if name == "all same":
        return np.full(m, 42, np.uint32)
    if name == "all distinct":
        return rng.permutation(1 << 20)[:m].astype(np.uint32)
    if name == "repeats that miss":
        # a few fresh keys repeated within each block of 8: they miss
        # together, and only the first of each row inserts
        fresh = np.repeat(np.arange(m // 4, dtype=np.uint32) + 1000, 4)
        return rng.permutation(fresh.reshape(-1, 8), axis=1).reshape(-1)[:m]
    raise KeyError(name)


STREAMS = ["zipf", "all same", "all distinct", "repeats that miss"]
# (d, w): a cache whose rows fill, one row of three slots, and rows of
# more than 32 slots (the kernel walks those in shared memory)
SHAPES = [(16, 4), (1, 3), (3, 40)]
BLOCKS = [2, 8, 32, 256]
M = 1024


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("d,w", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", STREAMS)
def test_block_walk_matches_block_oracle(name, block, d, w):
    x = stream(name, M, np.random.default_rng(block + d))
    keep, slots, valid, head = block_walk(torch.from_numpy(x.view(np.int32))
                                          .view(torch.uint32), d=d, w=w,
                                          block=block)
    want, (js, jv, jh) = jref.distinct_block_ref(
        jnp.asarray(x), d=d, w=w, block=block, seed=SEED, return_state=True)
    _eq(keep.to(torch.int32), want)
    _eq(slots[0], js)
    _eq(valid[0], jv)
    _eq(head[0], jh)


@pytest.mark.parametrize("d,w", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", STREAMS)
def test_block_walk_matches_pallas_kernel(name, block, d, w):
    x = stream(name, M, np.random.default_rng(block * 3 + d))
    keep = block_walk(torch.from_numpy(x.view(np.int32)).view(torch.uint32),
                      d=d, w=w, block=block)[0]
    want = distinct_prune_kernel(jnp.asarray(x), d=d, w=w, block=block,
                                 seed=SEED, interpret=True)
    _eq(keep.to(torch.int32), want)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("block", BLOCKS[:3])
def test_block_walk_lanes_match_per_lane_oracle(shards, block):
    """S lanes: each lane's keep and state are the block oracle's on that
    lane alone."""
    x = stream("zipf", M, np.random.default_rng(shards * block))
    keep, slots, valid, head = block_walk(
        torch.from_numpy(x.view(np.int32)).view(torch.uint32), d=8, w=2,
        block=block, shards=shards)
    n = M // shards
    for s in range(shards):
        want, (js, jv, jh) = jref.distinct_block_ref(
            jnp.asarray(x[s * n:(s + 1) * n]), d=8, w=2, block=block,
            seed=SEED, return_state=True)
        _eq(keep[s * n:(s + 1) * n].to(torch.int32), want)
        _eq(slots[s], js)
        _eq(valid[s], jv)
        _eq(head[s], jh)


def test_block_walk_on_the_trap_stream():
    x, want = TRAP
    keep, slots, valid, head = block_walk(
        torch.from_numpy(x.view(np.int32)).view(torch.uint32), d=1, w=1,
        block=2, seed=0)
    assert keep.to(torch.int32).tolist() == want
    ref_keep, (js, jv, jh) = jref.distinct_block_ref(
        jnp.asarray(x), d=1, w=1, block=2, seed=0, return_state=True)
    _eq(keep.to(torch.int32), ref_keep)
    _eq(slots[0], js)
    _eq(valid[0], jv)
    _eq(head[0], jh)
    _eq(keep.to(torch.int32), distinct_prune_kernel(
        jnp.asarray(x), d=1, w=1, block=2, seed=0, interpret=True))


def test_dropping_every_repeat_is_wrong_on_the_trap_stream():
    """The B = 1 walk's collapse (a repeat of its segment predecessor's key
    hits) marks entry 4 of the trap stream a hit; the reference keeps it."""
    x, want = TRAP
    assert x[4] == x[3] and want[4] == 1


@pytest.mark.parametrize("d,w", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
def test_block_walk_float_keys_match_port_oracle(block, d, w):
    """float32 keys: the slot stores the value converted to uint32 and only
    a value that converts back hits (4.5 fills a slot that 4.0 hits); held
    against the port's block oracle, bit for bit."""
    rng = np.random.default_rng(block + w)
    x = rng.choice(np.array([4.5, 4.0, -1.0, 7.0, np.nan, 2.0 ** 32, 0.0,
                             -0.0, 3.0, 4.0], np.float32), M)
    xt = torch.from_numpy(x)
    got = block_walk(xt, d=d, w=w, block=block)
    keep, state = tref.distinct_block_ref(xt[None], d=d, w=w, block=block,
                                          seed=SEED, return_state=True)
    assert torch.equal(got[0], keep[0])
    for a, b in zip(got[1:], state):
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a,
                           b.view(torch.int32) if b.dtype == torch.uint32
                           else b)


@pytest.mark.parametrize("shards", [1, 2])
def test_block_walk_entry_point_on_the_cpu(shards):
    """``parallel.distinct_block_walk_kernel`` on a CPU tensor is the plain
    version: the same outputs as ``distinct_shard_states_kernel`` and, lane
    by lane, the JAX package's block oracle."""
    x = stream("zipf", M, np.random.default_rng(shards))
    xt = torch.from_numpy(x.view(np.int32)).view(torch.uint32)
    got = tpar.distinct_block_walk_kernel(xt, d=16, w=4, shards=shards,
                                          block=32, seed=SEED)
    want = tpar.distinct_shard_states_kernel(xt, d=16, w=4, shards=shards,
                                             block=32, seed=SEED)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _eq(a.view(torch.int32) if a.dtype == torch.uint32 else a,
            b.view(torch.int32) if b.dtype == torch.uint32 else b)
    n = M // shards
    for s in range(shards):
        keep = jref.distinct_block_ref(jnp.asarray(x[s * n:(s + 1) * n]),
                                       d=16, w=4, block=32, seed=SEED)
        _eq(got[0][s * n:(s + 1) * n].to(torch.int32), keep)
