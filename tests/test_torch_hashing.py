"""The port's hashing is bit-exact with the JAX package's host and kernel hashes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as jh
from repro.kernels import common as jkc
from repro_torch.core import hashing as th

EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint32)


def _keys(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, 1 << 32, n, dtype=np.uint64)
                           .astype(np.uint32), EDGES])


@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF])
def test_mix32_matches(seed):
    x = _keys(seed & 7)
    want = np.asarray(jh.mix32(jnp.asarray(x), seed))
    got = th.mix32(torch.from_numpy(x), seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("mod", [1, 2, 7, 64, 512, 4096, 65535, 65536, 65537,
                                 1 << 20, 3_000_017])
@pytest.mark.parametrize("seed", [0, 3])
def test_hash_mod_matches_both_branches(mod, seed):
    x = _keys(mod % 5)
    want = np.asarray(jh.hash_mod(jnp.asarray(x), mod, seed))
    got = th.hash_mod(torch.from_numpy(x), mod, seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < mod
    if mod < (1 << 16):  # the in-kernel helper, which the CUDA header mirrors
        kern = np.asarray(jkc.hash_mod(jnp.asarray(x), mod, seed))
        np.testing.assert_array_equal(got, kern)


@pytest.mark.parametrize("small", [True, False])
def test_hash_mod_dyn_matches(small):
    x = _keys(9)
    mod = 1000 if small else 70_000
    want = np.asarray(jh.hash_mod_dyn(jnp.asarray(x), mod, 5, small=small))
    got = th.hash_mod_dyn(torch.from_numpy(x), mod, 5, small=small).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_as_u32_reads_the_bits(dtype):
    rng = np.random.default_rng(1)
    x = rng.integers(-1000, 1000, 64).astype(dtype)
    want = np.asarray(jh.as_u32(jnp.asarray(x)))
    got = th.as_u32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # indices hash like uint32 stream positions
    idx = np.arange(100, dtype=np.uint32)
    np.testing.assert_array_equal(
        th.hash_mod(torch.arange(100), 512, 2).numpy(),
        np.asarray(jh.hash_mod(jnp.asarray(idx), 512, 2)))


@pytest.mark.parametrize("mod", [3, 1024, 65537, 1 << 20])
@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_multi_hash_matches(mod, seed):
    x = _keys(mod % 3)
    want = np.asarray(jh.multi_hash(jnp.asarray(x), mod, 4, seed=seed))
    got = th.multi_hash(torch.from_numpy(x), mod, 4, seed=seed).numpy()
    assert got.shape == (x.shape[0], 4)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < mod
