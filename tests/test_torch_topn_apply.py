"""The TOP-N apply's plain version, in both families, against the JAX
package on the layouts the card's kernel (``csrc/topn.cu``, ``topn_apply``)
cuts the stream into: shard lengths L with L % 4 in {0, 1, 2, 3} (shards
off 16 bytes), values as a view 1 or 3 entries into their storage, merged
matrices of w = 1 and 8 read in place (a strided view), and row minima of
+-0, +-1e-40, +inf, -inf and NaN.

The kernels' family is held to ``topn_apply_kernel`` in interpret mode
(the Pallas one-hot read, ROADMAP B15), the engine's to the engine's
two_pass body (``apply_merged``). The kernel is held to this plain version
on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.topn import TopNRandState
from repro.kernels import parallel as jpar
from repro_torch.kernels import parallel as tpar

NAN, INF, SUB = float("nan"), float("inf"), 1e-40
D = 8
# the last column of each merged matrix (the row minima), one row special
COLUMNS = {
    "zeros and subnormals": [0.0, -0.0, SUB, -SUB, 0.5, -0.5, 0.0, SUB],
    "+inf": [0.3, INF, -0.2, 0.0, 0.1, -SUB, 0.7, -1.0],
    "-inf": [0.3, -INF, -0.2, 0.0, 0.1, SUB, 0.7, -1.0],
    "nan": [0.3, 0.1, NAN, -0.0, 0.1, SUB, 0.7, -1.0],
    "two infs": [INF, 0.1, -INF, 0.0, 0.1, SUB, 0.7, -1.0],
}


def _values(S, L, off, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(S * L + off).astype(np.float32)
    salt = rng.random(v.shape) < 0.25
    v[salt] = rng.choice(np.array([0.0, -0.0, SUB, -SUB], np.float32),
                         int(salt.sum()))
    return v


def _merged(col, w):
    wide = np.full((D, w + 3), 9.0, np.float32)
    wide[:, w - 1] = np.array(col, np.float32)
    return wide


@pytest.mark.parametrize("family", ["kernel", "engine"])
@pytest.mark.parametrize("w", [1, 8])
@pytest.mark.parametrize("S,L,off", [(3, 8, 0), (3, 5, 1), (2, 6, 0),
                                     (2, 7, 3)])
def test_topn_apply_plain_matches_the_reference(family, w, S, L, off):
    storage = _values(S, L, off, seed=L + w)
    x = torch.from_numpy(storage)[off:]          # a view `off` entries in
    v = storage[off:]
    for name, col in COLUMNS.items():
        wide = _merged(col, w)
        merged = torch.from_numpy(wide)[:, :w]   # a strided view, read in place
        got = tpar.topn_apply_kernel(x, merged, d=D, shards=S, seed=3,
                                     family=family)
        if family == "kernel":
            want = np.asarray(jpar.topn_apply_kernel(
                jnp.asarray(v), jnp.asarray(wide[:, :w]), d=D, shards=S,
                block=1, seed=3)).astype(bool)
        else:
            state = TopNRandState(vals=jnp.asarray(wide[:, :w]))
            want = np.asarray(jeng.apply_merged(
                "topn_rand", state, (jnp.asarray(v).reshape(S, L),), None,
                d=D, seed=3)).reshape(-1)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_topn_apply_refuses_a_bad_family():
    with pytest.raises(ValueError):
        tpar.topn_apply_kernel(torch.zeros(8), torch.zeros(4, 2), d=4,
                               shards=2, family="mesh")
