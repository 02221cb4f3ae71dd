"""The cluster layout of the ``bloom_build`` kernel, as a short pure-torch
mirror, bit for bit against the JAX package's Bloom builds.

``csrc/bloom.cu`` holds a filter of nwords words in the shared memory of a
thread-block cluster of K CTAs: CTA r owns the words
[r * slice, (r + 1) * slice), slice = ``bloom_cluster_slice(nwords, K)``
(ceil(nwords / K), rounded up to 4 words; ``cluster_slice`` below mirrors
it, as the layout lives in the CUDA source alone), so word b // 32 of bit b
lies in CTA (b // 32) // slice at local word (b // 32) % slice. Each cluster
takes its share of the keys, ORs every probed bit into the owning CTA's
slice (the probes travel to their owner in bins), and ORs its copy of the
filter into the result. OR is idempotent, so the result does not depend on
how the keys are shared out.

The mirror below builds the per-cluster copies in that layout over ranges
of the keys and ORs them. It is held against ``repro.core.sketches.
bloom_build`` (the engine's hash family, with and without a mask) and the
Pallas ``bloom_build_kernel`` in interpret mode (the kernels' family,
nbits < 2^16), on ragged nbits, nbits below 32 * K (CTAs that own no
word), m = 0 and m = 1. The kernel runs only on the card, where
``chip_smoke.py`` holds it against the plain version and the global-atomic
kernel it replaced.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketches as jsk
from repro.kernels import bloom_filter as jbf
from repro_torch.kernels import bloom_filter as B

H = 3
MAX_SMEM = 232448  # bytes of shared memory a Hopper CTA can opt into


def cluster_slice(nwords, K):
    """Words each CTA of a cluster of K owns (``bloom_cluster_slice`` of
    ``csrc/bloom.cu``): ceil(nwords / K), rounded up to 4 words."""
    return (-(-nwords // K) + 3) & ~3


def owner(bits, nwords, K):
    """(rank, local word) of each bit in a cluster of K CTAs."""
    sl = cluster_slice(nwords, K)
    word = bits >> 5
    return word // sl, word % sl


def cluster_build(keys, mask, *, nbits, seed, family, K, clusters):
    """Packed words of the filter, built as ``clusters`` clusters of K CTAs
    would build it: cluster q takes the q-th range of the keys, sets each
    probed bit in its copy at (rank, local word), and the copies are ORed."""
    nw = B.num_words(nbits)
    sl = cluster_slice(nw, K)
    idx = B.probe_bits(keys, nbits, H, seed, family)           # [m, H]
    keep = torch.ones(keys.shape[0], dtype=torch.bool) if mask is None \
        else mask
    copies = torch.zeros(clusters, K, sl * 32, dtype=torch.bool)
    bounds = np.linspace(0, keys.shape[0], clusters + 1).astype(int)
    for q in range(clusters):
        b = idx[bounds[q]:bounds[q + 1]][keep[bounds[q]:bounds[q + 1]]]
        b = b.reshape(-1)
        b = b[b >= 0]  # a dropped probe of the kernels' family sets nothing
        rank, local = owner(b, nw, K)
        copies[q, rank, local * 32 + (b & 31)] = True
    words = B.pack_bits(copies.any(0).reshape(-1))            # [K * sl]
    assert not B.unpack_bits(words, K * sl * 32)[nbits:].any()
    return words[:nw]


def keys_of(m, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 31), 1 << 31, m, dtype=np.int64) \
        .astype(np.int32), rng.random(m) < 0.6


@lru_cache(maxsize=None)
def reference(nbits, m, family, masked):
    """bool[nbits] of the JAX package's build: the engine's scatter
    (core.sketches.bloom_build, seed 7) or the Pallas kernel (seed 0)."""
    keys, mask = keys_of(m, nbits + m)
    if family == "engine":
        f = jsk.bloom_build(jnp.asarray(keys), nbits, H, seed=7,
                            mask=jnp.asarray(mask) if masked else None)
        return np.asarray(f.bits)
    if m == 0:
        return np.zeros(nbits, bool)
    # int32 keys: the Pallas hash takes them with signed shifts, as the
    # port's kernel family does for an int32 key
    bits = jbf.bloom_build_kernel(jnp.asarray(keys), nbits=nbits,
                                  num_hashes=H, block=m, seed=0,
                                  interpret=True)
    return np.asarray(bits) > 0.5


@pytest.mark.parametrize("clusters", [1, 3])
@pytest.mark.parametrize("K", [2, 5, 16])
@pytest.mark.parametrize("m", [0, 1, 777])
@pytest.mark.parametrize("nbits", [37, 100, 1000, 12345])
@pytest.mark.parametrize("family,masked", [("engine", False),
                                           ("engine", True),
                                           ("kernel", False)])
def test_cluster_layout_matches_reference(family, masked, nbits, m, K,
                                          clusters):
    keys, mask = keys_of(m, nbits + m)
    words = cluster_build(torch.from_numpy(keys),
                          torch.from_numpy(mask) if masked else None,
                          nbits=nbits, seed=7 if family == "engine" else 0,
                          family=family, K=K, clusters=clusters)
    np.testing.assert_array_equal(B.unpack_bits(words, nbits).numpy(),
                                  reference(nbits, m, family, masked))


@pytest.mark.parametrize("K", [2, 5, 16])
@pytest.mark.parametrize("nbits", [1, 37, 511, 512, 513, 12345, 1 << 24])
def test_each_word_has_one_owner(nbits, K):
    """Every word of the filter lies in exactly one CTA's slice, at its
    offset in the flattened [K, slice] layout; slices are whole 16-byte
    vectors."""
    nw = B.num_words(nbits)
    sl = cluster_slice(nw, K)
    assert sl % 4 == 0 and K * sl >= nw
    rank, local = owner(torch.arange(nbits, dtype=torch.int64), nw, K)
    assert int(rank.max()) < K and int(local.max()) < sl
    np.testing.assert_array_equal((rank * sl + local).numpy(),
                                  np.arange(nbits) >> 5)


JOIN_BITS = 1 << 24


@pytest.mark.parametrize("nbits,m,K,route", [
    (1 << 15, 1 << 20, 0, "staged"), (48 * 1024 * 8, 1 << 20, 0, "staged"),
    (48 * 1024 * 8 + 1, 1 << 20, 2, "cluster"),
    (JOIN_BITS, 1 << 25, 16, "cluster"), (JOIN_BITS, 1 << 20, 16, "cluster"),
    (JOIN_BITS, 1 << 18, 16, "global"), (JOIN_BITS, 7, 16, "global"),
    (19_000_000, 1 << 25, 0, "global")])
def test_route_by_shape(nbits, m, K, route):
    """The dispatch rule: 48 KB or less is staged whole in each CTA; above
    that the cluster build takes a filter that a cluster holds (K > 0, as
    the card's plan says) once the keys set CLUSTER_MIN_PROBES probes a
    filter word, and the global atomics take the rest: JOIN's F_A (2^25
    keys, 2^24 bits) and F_B (2^20 keys) go to the cluster, 2^18 keys and
    a handful of keys to the global atomics, as does a filter no cluster
    holds."""
    assert B.bloom_route(nbits, H, m, K) == route
    nw = B.num_words(nbits)
    if route != "staged":
        edge = -(-B.CLUSTER_MIN_PROBES * nw // H)  # fewest keys that reach it
        assert B.bloom_route(nbits, H, edge, K) == ("cluster" if K
                                                    else "global")
        assert B.bloom_route(nbits, H, edge - 1, K) == "global"


def test_join_filter_takes_sixteen_slices_of_128_kib():
    """JOIN's 2^24-bit filter (2 MiB) takes clusters of 16 CTAs: their
    slices are 2^15 words (128 KiB) each, and the 2^16-word slices of a
    cluster of 8 do not fit a CTA's shared memory."""
    nw = B.num_words(JOIN_BITS)
    assert cluster_slice(nw, 16) == 1 << 15
    assert cluster_slice(nw, 16) * 4 <= MAX_SMEM < cluster_slice(nw, 8) * 4
