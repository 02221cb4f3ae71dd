"""The row-parallel walk of TOP-N's pass 1 with block semantics, as a short
pure-torch mirror, bit for bit against the JAX package's block oracle and
its Pallas kernel. On the card the same walk takes every B: at B = 1 each
entry is a group of its own, and it is the engine's one-entry scan.

Under block semantics (``repro.kernels.ref.topn_block_ref``) every entry of
a block of B entries is kept iff its value >= its row's minimum as the row
stood before the block, and each row then takes its best candidate of the
block (the scatter max of the block's entries of that row: NaN if any is
NaN, whatever its sign, else the largest with +0 above -0) when that beats
the row's minimum. An entry reads and writes only the row that its
shard-local index hashes to, so ``csrc/topn.cu`` walks each (lane, row) on
its own:

1. partition: a stable sort of the stream by (lane, row), stream order
   kept within each segment, so that a block's entries of one row (a
   group) are contiguous;
2. walk: windows of 32 entries. A segmented max gives each group's
   candidate; each entry keeps iff value >= the row's minimum, and the row
   changes only at the end of a group whose candidate beats that minimum.
   The window's last group stays open: its running candidate is carried
   into the next window, and it is closed (its insert made) when the next
   window starts with another block, or when the segment ends.

The mirror below is that design on the CPU, held against
``repro.kernels.ref.topn_block_ref`` (keep and the final matrix, by bits
with every NaN as one) and ``repro.kernels.topn_prune.topn_prune_kernel``
in interpret mode (keep). The kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version and the block kernel.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.topn_prune import topn_prune_kernel
from repro_torch.core.hashing import hash_mod
from repro_torch.kernels import parallel as tpar

WARP = 32
I32_MAX = 0x7FFFFFFF
NEG = np.float32(-3.4e38)
NNAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
PNAN = np.array([0x7FC00000], np.uint32).view(np.float32)[0]


def ordered(v):
    """The order-preserving int image of an f32 (-0 below +0), every NaN
    above all."""
    if v != v:
        return I32_MAX
    i = int(np.float32(v).view(np.int32))
    return i ^ I32_MAX if i < 0 else i


def unordered(o):
    return np.int32(o ^ I32_MAX if o < 0 else o).view(np.float32)


def insert(row, c):
    """The sorted insert of c > row[-1] at pos = #(c <= row)."""
    pos = sum(bool(c <= r) for r in row)
    row[pos + 1:] = row[pos:-1]
    row[pos] = c


def walk_segment(vals, blks, w):
    """The walk of one segment: (keep, final row)."""
    row = [NEG] * w
    keep = [False] * len(vals)
    carry = None  # (block, running candidate) of the open group

    def close(group):
        c = unordered(group[1])
        if c > row[-1]:
            insert(row, c)

    for lo in range(0, len(vals), WARP):
        hi = min(lo + WARP, len(vals))
        if carry is not None and blks[lo] != carry[0]:
            close(carry)
            carry = None
        cand = []
        for e in range(lo, hi):
            o = ordered(vals[e])
            if e > lo and blks[e - 1] == blks[e]:
                o = max(o, cand[-1])
            elif carry is not None and blks[e] == carry[0]:
                o = max(o, carry[1])
            cand.append(o)
        done = lo
        for e in range(lo, hi - 1):
            if blks[e + 1] != blks[e] and unordered(cand[e - lo]) > row[-1]:
                for j in range(done, e + 1):
                    keep[j] = bool(vals[j] >= row[-1])
                insert(row, unordered(cand[e - lo]))
                done = e + 1
        for j in range(done, hi):
            keep[j] = bool(vals[j] >= row[-1])
        carry = (blks[hi - 1], cand[-1])
    if carry is not None:
        close(carry)
    return keep, row


def partition(m, *, d, block, seed, shards):
    """(order, segment starts, block ids) of the stable partition by
    (lane, row), the row hashed from the shard-local index."""
    n = m // shards
    idx = torch.arange(m)
    seg = (idx // n) * d + hash_mod(idx % n, d, seed)
    order = torch.sort(seg, stable=True).indices
    starts = torch.searchsorted(seg[order], torch.arange(shards * d + 1))
    return order, starts, (idx % n) // block


def block_walk(x, *, d, w, block, seed, shards=1):
    """The block walk over S lanes of f32 x [m]: (keep bool[m], states
    f32[S, d, w])."""
    m = x.shape[0]
    order, starts, blk = partition(m, d=d, block=block, seed=seed,
                                   shards=shards)
    xs = x.numpy()
    keep = np.zeros(m, bool)
    states = np.full((shards * d, w), NEG, np.float32)
    for g in range(shards * d):
        sel = order[int(starts[g]):int(starts[g + 1])].numpy()
        if sel.size:
            kp, row = walk_segment(list(xs[sel]), blk[sel].tolist(), w)
            keep[sel] = kp
            states[g] = row
    return torch.from_numpy(keep), torch.from_numpy(states).reshape(
        shards, d, w)


def group_shapes(m, *, d, block, seed, shards=1):
    """(longest group, groups that end at the last lane of a window) of the
    partitioned stream: the walk carries a group across windows."""
    order, starts, blk = partition(m, d=d, block=block, seed=seed,
                                   shards=shards)
    longest, at_edge = 0, 0
    for g in range(shards * d):
        b = blk[order[int(starts[g]):int(starts[g + 1])]].tolist()
        run = 0
        for e in range(len(b)):
            run = run + 1 if e and b[e] == b[e - 1] else 1
            longest = max(longest, run)
            if e % WARP == WARP - 1 and (e + 1 == len(b) or b[e + 1] != b[e]):
                at_edge += 1
    return longest, at_edge


def stream(name, m, block, rng):
    """The streams of chip_smoke.py's TOP-N block cases, made with numpy."""
    r = (rng.random(m) * 1000).astype(np.float32)
    if name == "random":
        return r
    if name == "ascending":  # every group inserts
        return np.arange(m, dtype=np.float32)
    if name == "all equal":
        return np.full(m, 3.0, np.float32)
    if name == "zeros":  # -0 and +0 mixed inside each block
        return rng.choice(np.array([-0.0, 0.0, -1.0], np.float32), m)
    if name == "nan mid-block":  # beside a value that beats the row minimum
        for b in range(0, m, 3 * block):
            mid = b + block // 2
            r[mid - 1], r[mid] = 5000.0, NNAN
            r[(mid + 1) % m] = PNAN
        return r
    if name == "nan at a block boundary":
        r[block - 1::4 * block] = NNAN
        r[block::4 * block] = PNAN
        return r
    if name == "low":  # at, just below and just above NEG, and -inf
        low = np.array([NEG, np.nextafter(NEG, np.float32(-np.inf)),
                        np.nextafter(NEG, np.float32(0)), -np.inf],
                       np.float32)
        r[::2] = rng.choice(low, r[::2].shape[0])
        return r
    raise KeyError(name)


STREAMS = ["random", "ascending", "all equal", "zeros", "nan mid-block",
           "nan at a block boundary", "low"]
# (d, w): one row of one slot and of eight, rows that take few entries
# each, the main path's d, and rows of more than 32 slots (the kernel
# walks those in shared memory)
SHAPES = [(1, 1), (1, 8), (37, 8), (512, 8), (1, 33), (37, 40)]
BLOCKS = [1, 2, 32, 256]
M = 2048


def _bits(a):
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.uint32)


def _case(name, block, d):
    """A case's stream, from a seed of its own, and its hash seed (one a
    shape: the JAX functions compile once for each static argument)."""
    rng = np.random.default_rng(STREAMS.index(name) * 1000 + block + d)
    return stream(name, M, block, rng), d % 5


@functools.lru_cache(maxsize=None)
def _walked(name, block, d, w):
    """(stream, hash seed, the mirror's keep and states) of one case, for
    both tests that take it."""
    x, seed = _case(name, block, d)
    return (x, seed) + block_walk(torch.from_numpy(x), d=d, w=w,
                                  block=block, seed=seed)


@pytest.mark.parametrize("d,w", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", STREAMS)
def test_block_walk_matches_block_oracle(name, block, d, w):
    x, seed, keep, states = _walked(name, block, d, w)
    want, js = jref.topn_block_ref(jnp.asarray(x), d=d, w=w, block=block,
                                   seed=seed, return_state=True)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want) > 0)
    np.testing.assert_array_equal(_bits(states[0]), _bits(js))


@pytest.mark.parametrize("d,w", SHAPES)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", STREAMS)
def test_block_walk_matches_pallas_kernel(name, block, d, w):
    x, seed, keep, _ = _walked(name, block, d, w)
    want = topn_prune_kernel(jnp.asarray(x), d=d, w=w, block=block,
                             seed=seed, interpret=True)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want) > 0)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("block", BLOCKS[:3])
def test_block_walk_lanes_match_per_lane_oracle(shards, block):
    """S lanes: each lane's keep and matrix are the block oracle's on that
    lane alone (each lane hashes its shard-local index)."""
    x, seed = _case("random", block, shards)
    keep, states = block_walk(torch.from_numpy(x), d=8, w=3, block=block,
                              seed=seed, shards=shards)
    n = M // shards
    for s in range(shards):
        want, js = jref.topn_block_ref(jnp.asarray(x[s * n:(s + 1) * n]),
                                       d=8, w=3, block=block, seed=seed,
                                       return_state=True)
        np.testing.assert_array_equal(keep[s * n:(s + 1) * n].numpy(),
                                      np.asarray(want) > 0)
        np.testing.assert_array_equal(_bits(states[s]), _bits(js))


def test_cases_carry_groups_across_windows():
    """The cases above hold a group longer than a window (d = 1, B = 256:
    a block is one group of 256 entries) and groups that end exactly at a
    window's last lane (d = 1, B = 32: every window is one group), which
    the walk carries into the next window and closes there."""
    assert group_shapes(M, d=1, block=256, seed=1)[0] == 256
    longest, at_edge = group_shapes(M, d=1, block=32, seed=1)
    assert longest == WARP and at_edge == M // WARP


@pytest.mark.parametrize("shards", [1, 2])
def test_block_walk_entry_point_on_the_cpu(shards):
    """``parallel.topn_block_walk_kernel`` on a CPU tensor is the plain
    version: the same outputs as ``topn_shard_states_kernel``, and the
    mirror's."""
    x, seed = _case("nan mid-block", 32, shards)
    xt = torch.from_numpy(x)
    got = tpar.topn_block_walk_kernel(xt, d=16, w=4, shards=shards,
                                      block=32, seed=seed)
    want = tpar.topn_shard_states_kernel(xt, d=16, w=4, shards=shards,
                                         block=32, seed=seed)
    mirror = block_walk(xt, d=16, w=4, block=32, seed=seed, shards=shards)
    for a, b, c in zip(got, want, mirror):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a) if a.is_floating_point()
                                      else a.numpy(),
                                      _bits(b) if b.is_floating_point()
                                      else b.numpy())
        np.testing.assert_array_equal(_bits(a) if a.is_floating_point()
                                      else a.numpy(),
                                      _bits(c) if c.is_floating_point()
                                      else c.numpy())
