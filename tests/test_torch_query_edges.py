"""The Count-Min and Bloom queries at the edges of their inputs, against the
JAX package on the CPU.

The port's queries (``kernels.cms_sketch.cms_query_kernel``,
``kernels.bloom_filter.bloom_query_kernel`` and their ``ops`` and
``core.sketches`` entry points) run their plain versions here; the CUDA
queries are held to those on the card (``chip_smoke.py`` phase ``kernels``).
Each test feeds the same numpy-seeded input to both packages and asserts the
answers equal bit for bit, every NaN as one:

- ragged key counts and key views that start 1 and 3 entries into their
  storage (the CUDA queries load 16 bytes at a time after a scalar head);
- int32 keys at widths of 2^15 and up, where the Pallas kernels' signed
  hash drops a probe (Queue 3 B12);
- uint32 and narrow-integer tables of the engine's sketch;
- the shift or mask that the CUDA queries take for a width that is a power
  of two, against the families' hashes;
- tables with NaN, +-inf, -0, subnormal and FLT_MAX counters, and f32 bit
  vectors with a NaN or an infinity (Queue 3 A21-A24).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.core import sketches as jsk
from repro.kernels import ops as jops
from repro_torch import core as T
from repro_torch.core.hashing import mix32
from repro_torch.kernels import bloom_filter as tbf
from repro_torch.kernels import cms_sketch as tcms
from repro_torch.kernels import ops as tops

NAN, INF = float("nan"), float("inf")
FMAX = float(np.finfo(np.float32).max)
SPECIAL = (NAN, INF, -INF, -0.0, FMAX, 1e-40, -1e-40)


def _same(t, j):
    a, b = t.numpy(), np.asarray(j)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        nan = np.float32("nan")
        a = np.where(np.isnan(a), nan, a).view(np.int32)
        b = np.where(np.isnan(b), nan, b).view(np.int32)
    np.testing.assert_array_equal(a, b)


def _keys(m, seed, dtype=np.uint32, off=0):
    """m keys of ``dtype`` starting ``off`` entries into their storage."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-(2 ** 31), 2 ** 31, m + off).astype(np.int32)
    return k.view(dtype)[off:]


# ------------------------------------------- the power-of-two reduction
def _reduce_pow2(keys, width, seed, family):
    """A mirror of ``csrc/query.cuh``: the column of a power-of-two width as
    a shift of the mixed hash (the kernels' families below 2^16) or a mask
    (the engine's family, or 2^16 and up)."""
    signed = keys.dtype == torch.int32 and family != "engine"
    s = (seed * 0x9E3779B9 if family == "engine" else 101 * seed) & 0xFFFFFFFF
    h = mix32(keys, s, signed=signed) & 0xFFFFFFFF
    k = width.bit_length() - 1
    if family != "engine" and 1 < width < (1 << 16):
        return h >> (32 - k)
    return h & (width - 1)


@pytest.mark.parametrize("family", ["kernel", "engine"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("width", [1, 2, 64, 1024, 4096, 1 << 15, 1 << 16,
                                   1 << 20, 1 << 24])
def test_pow2_shift_or_mask_equals_the_hash(width, dtype, family):
    keys = torch.from_numpy(_keys(4096, width, dtype))
    for r in range(3):
        want = tcms.row_hashes(keys, 3, width, 0, family)[:, r]
        assert torch.equal(_reduce_pow2(keys, width, r, family), want)


# ------------------------------------------------ ragged keys and views
@pytest.mark.parametrize("m", [1, 3, 4, 255, 4097])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_cms_query_ragged_views(m, off):
    rng = np.random.default_rng(m + off)
    table = rng.integers(0, 9, (3, 4096)).astype(np.float32)
    k = _keys(m, m, np.uint32, off)
    _same(tops.cms_query(torch.from_numpy(table), torch.from_numpy(k)),
          jops.cms_query(jnp.asarray(table), jnp.asarray(k)))
    itab = table.astype(np.int32)[:, :1024]
    got = T.cms_query(T.CountMin(torch.from_numpy(itab)), torch.from_numpy(k))
    _same(got, J.cms_query(jsk.CountMin(jnp.asarray(itab)), jnp.asarray(k)))
    keep = T.cms_query(T.CountMin(torch.from_numpy(itab)),
                       torch.from_numpy(k), 4)
    _same(keep, J.cms_query(jsk.CountMin(jnp.asarray(itab)),
                            jnp.asarray(k)) > 4)


@pytest.mark.parametrize("m", [1, 3, 4, 255, 4097])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_bloom_query_ragged_views(m, off):
    rng = np.random.default_rng(7 * m + off)
    bits = (rng.random(1 << 15) < 0.4).astype(np.float32)
    k = _keys(m, m + 1, np.uint32, off)
    _same(tops.bloom_query(torch.from_numpy(bits), torch.from_numpy(k)),
          jops.bloom_query(jnp.asarray(bits), jnp.asarray(k)))
    src = _keys(2000, m)
    jf = jsk.bloom_build(jnp.asarray(src), 1 << 14)
    tf = T.bloom_build(torch.from_numpy(src), 1 << 14)
    probe = np.concatenate([src[:m // 2], k[m // 2:]])[off:]
    _same(T.bloom_query(tf, torch.from_numpy(probe)),
          jsk.bloom_query(jf, jnp.asarray(probe)))


# ---------------------------------------- int32 keys and dropped probes
@pytest.mark.parametrize("width", [1 << 15, 40000, 1 << 16])
@pytest.mark.parametrize("seed", range(2))
def test_cms_query_int32_keys_wide(width, seed):
    bad = np.array([-2040099539, -2010473350, -2006560011], np.int32)
    k = np.concatenate([bad, _keys(509, seed, np.int32)])
    table = np.random.default_rng(seed).integers(
        0, 9, (2, width)).astype(np.float32)
    want = jops.cms_query(jnp.asarray(table), jnp.asarray(k), seed=seed,
                          use_ref=width >= (1 << 16))
    _same(tops.cms_query(torch.from_numpy(table), torch.from_numpy(k),
                         seed=seed), want)


@pytest.mark.parametrize("nbits", [1 << 15, 40000, 1 << 16])
def test_bloom_query_int32_keys_wide(nbits):
    k = np.concatenate([np.array([-2040099539, -2010473350, -2006560011],
                                 np.int32), _keys(509, nbits, np.int32)])
    bits = (np.random.default_rng(nbits).random(nbits) < 0.7).astype(
        np.float32)
    for H in (1, 3):
        want = jops.bloom_query(jnp.asarray(bits), jnp.asarray(k),
                                num_hashes=H, use_ref=nbits >= (1 << 16))
        _same(tops.bloom_query(torch.from_numpy(bits), torch.from_numpy(k),
                               num_hashes=H), want)


# ------------------------------------------------- integer engine tables
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int16, np.int8,
                                   np.uint16, np.uint8])
def test_cms_query_integer_tables(dtype):
    rng = np.random.default_rng(3)
    k = _keys(3000, 4)[rng.integers(0, 3000, 3000)]
    w = rng.integers(0, 200, 3000).astype(dtype)
    jt = jsk.cms_build(jnp.asarray(k), jnp.asarray(w), 3, 64)
    tt = T.cms_build(torch.from_numpy(k), torch.from_numpy(w), 3, 64)
    _same(tt.table, jt.table)
    q = _keys(1001, 5)
    q[:500] = k[:500]
    _same(T.cms_query(tt, torch.from_numpy(q)),
          J.cms_query(jt, jnp.asarray(q)))
    for thr in (0, 100, 7000):
        _same(T.cms_query(tt, torch.from_numpy(q), thr),
              J.cms_query(jt, jnp.asarray(q)) > thr)


# ------------------------------------ non-finite, -0, subnormal, FLT_MAX
def _odd_table(rows, width, seed):
    """Small integer counters with SPECIAL values dropped in: none, one,
    two or a whole table of one, by the seed."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 5, (rows, width)).astype(np.float32)
    kind = seed % 4
    if kind == 3:
        t[:] = SPECIAL[seed // 4 % len(SPECIAL)]
    else:
        for _ in range(kind):
            t[rng.integers(rows), rng.integers(width)] = SPECIAL[
                rng.integers(len(SPECIAL))]
    return t


@pytest.mark.parametrize("rows, width", [(1, 64), (3, 64), (3, 4096),
                                         (2, 40000)])
@pytest.mark.parametrize("seed", range(12))
def test_cms_query_odd_tables_kernel_family(rows, width, seed):
    t = _odd_table(rows, width, seed)
    for k in (_keys(300, seed), _keys(300, seed, np.int32)):
        want = jops.cms_query(jnp.asarray(t), jnp.asarray(k),
                              use_ref=width >= (1 << 16))
        _same(tops.cms_query(torch.from_numpy(t), torch.from_numpy(k)), want)


@pytest.mark.parametrize("rows", [1, 2, 3])
@pytest.mark.parametrize("seed", range(12))
def test_cms_query_odd_tables_engine_family(rows, seed):
    t = _odd_table(rows, 64, seed)
    k = _keys(300, seed)
    jt, tt = jsk.CountMin(jnp.asarray(t)), T.CountMin(torch.from_numpy(t))
    _same(T.cms_query(tt, torch.from_numpy(k)),
          J.cms_query(jt, jnp.asarray(k)))
    for thr in (0.0, 2.5, -1e-40):
        want = jax.jit(lambda a, b: J.cms_query(jsk.CountMin(a), b) > thr)(
            jnp.asarray(t), jnp.asarray(k))
        _same(T.cms_query(tt, torch.from_numpy(k), thr), want)


@pytest.mark.parametrize("rows", [2, 3])
def test_cms_query_engine_minimum_takes_minus_zero(rows):
    # XLA's minimum orders -0 below +0 in either order of rows
    t = np.zeros((rows, 16), np.float32)
    t[1] = -0.0
    k = _keys(64, 9)
    for table in (t, t[::-1].copy()):
        got = T.cms_query(T.CountMin(torch.from_numpy(table)),
                          torch.from_numpy(k))
        assert got.signbit().all()
        _same(got, J.cms_query(jsk.CountMin(jnp.asarray(table)),
                               jnp.asarray(k)))


def _bloom_keys_all_at(nbits, H):
    """(keys whose H probes all hit one bit p, p): a search over 2^18 keys."""
    k = torch.from_numpy(_keys(1 << 18, nbits + H))
    idx = tbf.probe_bits(k, nbits, H, 0, "kernel")
    one = (idx == idx[:, :1]).all(1)
    p = int(torch.bincount(idx[one, 0]).argmax())
    return k[one & (idx[:, 0] == p)].numpy()[:16], p


@pytest.mark.parametrize("nbits, H", [(64, 1), (64, 2), (64, 3), (4096, 1)])
@pytest.mark.parametrize("case", ["inf", "nan", "-inf", "two", "elsewhere",
                                  "finite"])
def test_bloom_query_odd_bits(nbits, H, case):
    special, p = _bloom_keys_all_at(nbits, H)
    rng = np.random.default_rng(nbits + H)
    bits = (rng.random(nbits) < 0.6).astype(np.float32)
    bits[rng.random(nbits) < 0.1] = 0.7
    bits[rng.random(nbits) < 0.1] = 2.0
    bits[rng.random(nbits) < 0.1] = -1.0
    value = {"inf": INF, "nan": NAN, "-inf": -INF, "two": INF,
             "elsewhere": INF, "finite": 1.0}[case]
    bits[(p + 3) % nbits if case == "elsewhere" else p] = value
    if case == "two":
        bits[(p + 1) % nbits] = INF
    k = np.concatenate([special, _keys(500, H)])
    for keys in (k.view(np.int32), k):
        want = jops.bloom_query(jnp.asarray(bits), jnp.asarray(keys),
                                num_hashes=H)
        got = tops.bloom_query(torch.from_numpy(bits), torch.from_numpy(keys),
                               num_hashes=H)
        _same(got, want)
    if case == "inf":
        # the uint32 keys whose every probe hits the +inf bit are the ones
        # kept
        idx = tbf.probe_bits(torch.from_numpy(k), nbits, H, 0, "kernel")
        assert torch.equal(got, (idx == p).all(1))
        assert got[:len(special)].all()


def test_nonfinite_bits_on_the_device_of_the_bits():
    bits = torch.tensor([0.0, 1.0, INF, NAN, 1.0])
    assert tbf.nonfinite_bits(bits).tolist() == [2, 2]
    assert tbf.nonfinite_bits(bits[:2]).tolist() == [0, 0]
    assert tbf.nonfinite_bits(bits[:3]).tolist() == [1, 2]
    assert tbf.nonfinite_bits(bits).dtype == torch.int32
