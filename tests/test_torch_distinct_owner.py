"""DISTINCT's pass 2 as a lowest-owner lookup, as a short pure-torch
mirror, against the JAX package's apply kernel and its two-pass mirror.

Pass 2 drops a pass-1 survivor of lane s when a valid slot of its row in
the merged [d][S*w] union, among the columns of the shards below s, holds
its key (column c belongs to shard c // w). So the answer needs one number
per (row, key): the lowest shard whose valid slot of the row holds the
key. ``csrc/distinct.cu`` builds it once a row and then gives every
survivor one lookup:

1. build: each row's valid columns go into an open-addressed table of
   T = 2^tbits >= 2 * S * w slots, each the packed (owner << 32 | key),
   owner the lowest shard (a key already there keeps the smaller owner);
   a key's probe starts at the top tbits of mix32(key, 0x9E3779B9) and
   moves one slot at a time. The card inserts in no fixed order, so the
   mirror inserts the columns forward, backward and shuffled;
2. apply: a survivor that can hit (``ref.distinct_keys``) is dropped iff
   the owner of its key in its row is below its lane; an absent key has
   no owner.

Held against ``repro.kernels.parallel.distinct_apply_kernel`` in interpret
mode and ``distinct_parallel_ref`` (keep) on uint32 streams, and float32
keys against the port's ``parallel.distinct_apply_plain``, because the JAX
block kernels refuse them (ROADMAP Queue 3 A3). The kernels themselves
run only on the card, where ``chip_smoke.py`` holds them against the plain
version and the scan they replaced.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import parallel as jpar
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core.hashing import as_u32, hash_mod, mix32
from repro_torch.kernels import parallel as tpar
from repro_torch.kernels import ref as tref

EMPTY = (1 << 64) - 1
OWNER_SEED = 0x9E3779B9
M32 = 0xFFFFFFFF
SEED = 5
D = 8
BLOCK = 8
M = 4096


def owner_bits(sw):
    b = 1
    while (1 << b) < 2 * sw:
        b += 1
    return b


def homes(keys, tbits):
    """The first slot each key's probe takes."""
    return (mix32(keys, OWNER_SEED) >> (32 - tbits)).tolist()


def owner_tables(mslots, mvalid, w, order):
    """Each row's lowest-owner table (a list of T packed slots), the valid
    columns inserted in ``order``."""
    d, sw = mslots.shape
    tbits = owner_bits(sw)
    T = 1 << tbits
    keys = as_u32(mslots).tolist()
    first = homes(mslots, tbits)
    valid = mvalid.tolist()
    tables = []
    for r in range(d):
        t = [EMPTY] * T
        for c in order(sw):
            if not valid[r][c]:
                continue
            k = keys[r][c]
            e = (c // w) << 32 | k
            h = first[r][c]
            while t[h] != EMPTY and t[h] & M32 != k:
                h = (h + 1) & (T - 1)
            t[h] = min(t[h], e)  # EMPTY is above every entry
        tables.append(t)
    return tables, tbits


def owner_apply(values, keep1, mslots, mvalid, *, d, shards, seed,
                order=range):
    """keep bool[m]: keep1 and not owned by a lower lane."""
    m = values.shape[0]
    n = m // shards
    w = mslots.shape[1] // shards
    tables, tbits = owner_tables(mslots, mvalid, w, order)
    key, hittable = tref.distinct_keys(values)
    rows = hash_mod(values, d, seed).tolist()
    first = homes(key, tbits)
    keys = key.tolist()
    keep = keep1.clone()
    for i in torch.nonzero(keep1 & hittable).flatten().tolist():
        k, t, h = keys[i], tables[rows[i]], first[i]
        while t[h] != EMPTY and t[h] & M32 != k:
            h = (h + 1) & (len(t) - 1)
        if t[h] >> 32 < i // n:
            keep[i] = False
    return keep


ORDERS = {"forward": range,
          "backward": lambda n: range(n - 1, -1, -1),
          "shuffled": lambda n: np.random.default_rng(n).permutation(n)}


def stream(name, shards, rng):
    """uint32 keys, S lanes of M / S: a key in 90 % of every lane (every
    shard caches it), zipf keys, and a key that only the top lane holds."""
    if name == "hot key":
        x = rng.integers(0, 300, M)
        x[rng.random(M) < 0.9] = 7
    elif name == "zipf":
        x = rng.zipf(1.3, M) % 500
    elif name == "top lane only":
        x = rng.integers(0, 40, M)
        top = np.arange(M) >= M - M // shards
        x[top & (rng.random(M) < 0.5)] = 123456
    else:
        raise KeyError(name)
    return x.astype(np.uint32)


@functools.lru_cache(maxsize=None)
def port_states(name, shards, w):
    """A case's stream and the port's pass 1 on it (plain, block
    semantics): (x, keys uint32, keep1 bool[m], the merged union)."""
    x = stream(name, shards, np.random.default_rng(shards * 10 + w))
    t = torch.from_numpy(x.view(np.int32)).view(torch.uint32)
    keep1, slots, valid, _ = tpar.distinct_shard_states_kernel(
        t, d=D, w=w, shards=shards, block=BLOCK, seed=SEED)
    return (x, t, keep1) + tpar.merge_distinct_states(slots, valid)


@functools.lru_cache(maxsize=None)
def jax_two_pass(name, shards, w):
    """The JAX package's two-pass mirror on a case's stream: (keep, the
    block oracle's pass-1 keep), both bool[m]."""
    x = jnp.asarray(port_states(name, shards, w)[0])
    want, _ = jpar.distinct_parallel_ref(x, d=D, w=w, shards=shards,
                                         block=BLOCK, seed=SEED)
    jk1 = jax.vmap(lambda v: jref.distinct_block_ref(
        v, d=D, w=w, block=BLOCK, seed=SEED))(x.reshape(shards, -1))
    return np.asarray(want) > 0, np.asarray(jk1).reshape(-1) > 0


STREAMS = ["hot key", "zipf", "top lane only"]
SHARDS = [1, 2, 8, 128]
WS = [1, 4, 40]


@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", STREAMS)
def test_owner_apply_matches_pallas_apply(name, shards, w):
    """The JAX package's pass 1 and pass 2 kernels in interpret mode; the
    mirror takes their pass-1 keep and states."""
    x = stream(name, shards, np.random.default_rng(shards * 10 + w))
    keep1, lo, hi, jvalid = jpar.distinct_shard_states_kernel(
        jnp.asarray(x), d=D, w=w, shards=shards, block=BLOCK, seed=SEED)
    mlo, mhi, owner = jpar.merge_distinct_states(lo, hi, jvalid)
    want = jpar.distinct_apply_kernel(jnp.asarray(x), keep1, mlo, mhi, owner,
                                      d=D, shards=shards, block=BLOCK,
                                      seed=SEED)
    slots, valid = convert.distinct_kernel_state_from_numpy(
        np.asarray(lo), np.asarray(hi), np.asarray(jvalid), device="cpu")
    mslots, mvalid = tpar.merge_distinct_states(slots, valid)
    got = owner_apply(torch.from_numpy(x.view(np.int32)).view(torch.uint32),
                      torch.from_numpy(np.asarray(keep1) > 0), mslots,
                      mvalid, d=D, shards=shards, seed=SEED)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want) > 0)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", STREAMS)
def test_owner_apply_matches_parallel_ref(name, shards, w, order):
    """The JAX package's two-pass mirror (vmapped block oracle, then the
    engine's cache-union apply), whatever order the build inserts in."""
    _, t, keep1, mslots, mvalid = port_states(name, shards, w)
    want, jk1 = jax_two_pass(name, shards, w)
    np.testing.assert_array_equal(keep1.numpy(), jk1)
    got = owner_apply(t, keep1, mslots, mvalid, d=D, shards=shards,
                      seed=SEED, order=ORDERS[order])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("shards", SHARDS)
def test_owner_apply_float_keys_match_port(shards, w):
    """float32 keys: the slots hold the uint32 conversion of the value,
    and only a value that converts back can hit (4.0 hits the slot 4.5
    filled); held against the port's plain apply, which the JAX block
    kernels cannot be run on."""
    rng = np.random.default_rng(shards + w)
    x = rng.choice(np.array([4.5, 4.0, -1.0, 7.0, np.nan, 2.0 ** 32, 0.0,
                             -0.0, 3.0, np.inf, 5e9], np.float32), M)
    t = torch.from_numpy(x)
    keep1, slots, valid, _ = tpar.distinct_shard_states_kernel(
        t, d=D, w=w, shards=shards, block=BLOCK, seed=SEED)
    mslots, mvalid = tpar.merge_distinct_states(slots, valid)
    want = tpar.distinct_apply_plain(t, keep1, mslots, mvalid, d=D,
                                     shards=shards, seed=SEED)
    got = owner_apply(t, keep1, mslots, mvalid, d=D, shards=shards,
                      seed=SEED, order=ORDERS["shuffled"])
    assert torch.equal(got, want)


def test_owner_is_the_lowest_shard():
    """One row, three shards of one slot each, all holding key 9: the
    table keeps owner 0 in whatever order the build inserts, so lanes 1
    and 2 drop their 9 and lane 0 keeps it; a key held by no shard (11)
    is kept everywhere."""
    mslots = torch.tensor([[9, 9, 9]], dtype=torch.int32).view(torch.uint32)
    mvalid = torch.ones((1, 3), dtype=torch.bool)
    x = torch.tensor([9, 11, 9, 11, 9, 11], dtype=torch.int32).view(
        torch.uint32)
    for order in ORDERS.values():
        tables, _ = owner_tables(mslots, mvalid, 1, order)
        assert [e >> 32 for e in tables[0] if e != EMPTY] == [0]
        keep = owner_apply(x, torch.ones(6, dtype=torch.bool), mslots,
                           mvalid, d=1, shards=3, seed=0, order=order)
        assert keep.tolist() == [True, True, False, True, False, True]
