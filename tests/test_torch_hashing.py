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


# ---------------------------------------------- fingerprints (Ex. 8, Thm 4)
def _col(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "uint32":
        return np.concatenate([rng.integers(0, 1 << 32, n - len(EDGES),
                                            dtype=np.uint64)
                               .astype(np.uint32), EDGES])
    if kind == "int32":
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    return (rng.normal(size=n) * 1e3).astype(np.float32)


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint32
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["uint32", "int32", "float32"])
@pytest.mark.parametrize("bits", [1, 7, 16, 31, 32])
@pytest.mark.parametrize("seed", [0, 5, (1 << 32) - 101])
def test_fingerprint_one_column(kind, bits, seed):
    x = _col(kind, 512, bits)
    want = np.asarray(jh.fingerprint(jnp.asarray(x), bits=bits, seed=seed))
    got = th.fingerprint(torch.from_numpy(x), bits=bits, seed=seed)
    np.testing.assert_array_equal(_u32(got), want)


COLUMN_SETS = [("uint32", "int32"), ("float32", "uint32"),
               ("int32", "float32", "uint32"), ("uint32", "uint32", "int32")]


@pytest.mark.parametrize("kinds", COLUMN_SETS)
@pytest.mark.parametrize("bits", [1, 7, 16, 31, 32])
@pytest.mark.parametrize("seed", [0, 5])
def test_fingerprint_columns(kinds, bits, seed):
    """Lists of 2-3 mixed columns; the second of each list broadcasts from
    one row, so h * 0x9E3779B9 wraps over every lane."""
    cols = [_col(k, 384, i + bits) for i, k in enumerate(kinds)]
    cols[1] = cols[1][:1]
    want = np.asarray(jh.fingerprint([jnp.asarray(c) for c in cols],
                                     bits=bits, seed=seed))
    got = th.fingerprint([torch.from_numpy(c) for c in cols], bits=bits,
                         seed=seed)
    assert got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_fingerprint_seed_bounds(ncols):
    """seed + i * 101 converts as jnp.uint32 converts it: a seed of column i
    outside [0, 2^32) raises OverflowError in both packages."""
    x = _col("uint32", 16, 0)
    for seed in ((1 << 32) - 101, (1 << 32) - 1, 1 << 32, -1):
        cols_j = [jnp.asarray(x)] * ncols if ncols > 1 else jnp.asarray(x)
        cols_t = ([torch.from_numpy(x)] * ncols if ncols > 1
                  else torch.from_numpy(x))
        try:
            want = np.asarray(jh.fingerprint(cols_j, seed=seed))
        except OverflowError as e:
            with pytest.raises(OverflowError) as got:
                th.fingerprint(cols_t, seed=seed)
            assert str(got.value) == str(e)
            continue
        np.testing.assert_array_equal(_u32(th.fingerprint(cols_t, seed=seed)),
                                      want)


def test_fingerprint_bits_above_32_raise():
    with pytest.raises(ValueError, match="bits must be <= 32"):
        th.fingerprint(torch.zeros(3, dtype=torch.int32), bits=33)
    with pytest.raises(ValueError, match="bits must be <= 32"):
        jh.fingerprint(jnp.zeros(3, jnp.int32), bits=33)


@pytest.mark.parametrize("d,D,delta", [
    (1024, 10**6, 1e-3),     # D > d ln(2d/delta): the load regime
    (1024, 5000, 1e-3),      # d ln(1/delta)/e <= D: the middle regime
    (1024, 100, 1e-3),       # the sparse regime
    (64, 1, 0.5), (4096, 2**20, 1e-6), (16, 20, 0.01)])
def test_fingerprint_bits_thm4(d, D, delta):
    assert th.fingerprint_bits_thm4(d, D, delta) == \
        jh.fingerprint_bits_thm4(d, D, delta)


# ------------------------------------------------------- compact_argsort
@pytest.mark.parametrize("shape", [(301,), (301, 4)])
@pytest.mark.parametrize("rate", [0.0, 0.35, 1.0])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_compact_argsort_matches(shape, rate, dtype):
    from repro.core import pruning as jp
    from repro_torch.core import pruning as tp

    rng = np.random.default_rng(int(rate * 100) + len(shape))
    v = (rng.integers(-999, 999, shape).astype(dtype) if dtype == np.int32
         else rng.normal(size=shape).astype(dtype))
    keep = rng.random(shape[0]) < rate
    want, wc = jp.compact_argsort(jnp.asarray(v), jnp.asarray(keep),
                                  fill=-7)
    got, gc = tp.compact_argsort(torch.from_numpy(v), torch.from_numpy(keep),
                                 fill=-7)
    assert int(gc) == int(wc) == int(keep.sum())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the O(m) scatter compact moves the rows the same way
    np.testing.assert_array_equal(
        tp.compact(torch.from_numpy(v), torch.from_numpy(keep),
                   fill=-7)[0].numpy(), got.numpy())
