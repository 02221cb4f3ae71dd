"""The compacted merged SKYLINE set of the card's pass 2 against the JAX
package's apply kernel.

The card's ``skyline_apply`` first compacts the S*w merged points (valid
points only, no point another dominates, one of each group of equal points,
ordered by score) and then tests the entries against what is left.
``skyline_compact_plain`` mirrors the compaction. Here the plain apply
against the compacted set must give, bit for bit, the mask that the Pallas
``skyline_apply_kernel`` (interpret mode, as the JAX package's own tests run
it) gives against the whole set, on sets that hold NEG slots, NaN scores,
NaN and +-inf coordinates, +-0, duplicate points and sets where one point
dominates all others.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import parallel as jpar
from repro_torch.constants import NEG
from repro_torch.kernels import parallel as tpar

NAN, INF = float("nan"), float("inf")
BLOCK = 64


def _merged(sw, D, rng, kind):
    """A merged set f32[sw, D] + f32[sw] of the given kind."""
    pts = rng.integers(-6, 7, (sw, D)).astype(np.float32)
    scs = rng.normal(size=sw).astype(np.float32) * 4
    if kind == "specials":
        flat = pts.reshape(-1)
        pick = rng.random(flat.shape[0])
        flat[pick < 0.05] = NAN
        flat[(pick >= 0.05) & (pick < 0.1)] = INF
        flat[(pick >= 0.1) & (pick < 0.15)] = -INF
        flat[(pick >= 0.15) & (pick < 0.3)] = -0.0
        flat[(pick >= 0.3) & (pick < 0.45)] = 0.0
        s = rng.random(sw)
        scs[s < 0.2] = np.float32(NEG)
        scs[(s >= 0.2) & (s < 0.3)] = NAN
        scs[(s >= 0.3) & (s < 0.35)] = np.float32(-INF)
    elif kind == "duplicates":
        pts = pts[rng.integers(0, max(1, sw // 4), sw)]
        scs = np.round(scs)
        scs[rng.random(sw) < 0.25] = np.float32(NEG)
    elif kind == "one_dominates":
        pts[rng.integers(0, sw)] = 100.0
    elif kind == "all_neg":
        scs[:] = np.float32(NEG)
    return pts, scs.astype(np.float32)


def _entries(m, D, rng):
    x = rng.integers(-7, 8, (m, D)).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.random(flat.shape[0])
    flat[pick < 0.03] = NAN
    flat[(pick >= 0.03) & (pick < 0.06)] = INF
    flat[(pick >= 0.06) & (pick < 0.09)] = -INF
    flat[(pick >= 0.09) & (pick < 0.2)] = -0.0
    return x


@pytest.mark.parametrize("kind", ["random", "specials", "duplicates",
                                  "one_dominates", "all_neg"])
@pytest.mark.parametrize("sw,D", [(1, 1), (8, 2), (32, 3), (64, 8),
                                  (128, 2)])
@pytest.mark.parametrize("seed", range(2))
def test_compacted_apply_matches_pallas_on_full_set(kind, sw, D, seed):
    rng = np.random.default_rng(1000 * seed + 10 * sw + D)
    mp, ms = _merged(sw, D, rng, kind)
    x = _entries(4 * BLOCK, D, rng)
    want = np.asarray(jpar.skyline_apply_kernel(
        jnp.asarray(x), jnp.asarray(mp), jnp.asarray(ms), block=BLOCK))
    kp, ks = tpar.skyline_compact_plain(torch.from_numpy(mp),
                                        torch.from_numpy(ms))
    got = tpar.skyline_apply_plain(torch.from_numpy(x), kp, ks)
    np.testing.assert_array_equal(got.numpy(), want.astype(bool))
    # the whole set through the port's plain apply agrees too
    full = tpar.skyline_apply_plain(torch.from_numpy(x),
                                    torch.from_numpy(mp),
                                    torch.from_numpy(ms))
    np.testing.assert_array_equal(full.numpy(), want.astype(bool))


@pytest.mark.parametrize("seed", range(3))
def test_compacted_set_is_valid_undominated_distinct_and_ordered(seed):
    rng = np.random.default_rng(seed)
    mp, ms = _merged(96, 3, rng, "specials")
    kp, ks = tpar.skyline_compact_plain(torch.from_numpy(mp),
                                        torch.from_numpy(ms))
    k = kp.shape[0]
    assert bool((ks > NEG).all()) and not bool(kp.isnan().any())
    assert bool((ks[:-1] >= ks[1:]).all())
    for i in range(k):
        for j in range(k):
            if i == j:
                continue
            a, b = kp[i], kp[j]
            assert not bool((b <= a).all() & (b < a).any())
            assert not bool((a == b).all())


def test_compaction_keeps_the_lowest_index_of_equal_points():
    mp = torch.tensor([[1.0, 2.0], [-0.0, 3.0], [0.0, 3.0], [1.0, 2.0]])
    ms = torch.tensor([5.0, 4.0, 6.0, 5.0])
    kp, ks = tpar.skyline_compact_plain(mp, ms)
    # (1, 2) is dominated by neither zero point (2 < 3 but 1 > 0); of the
    # equal zeros index 1 stays, of the equal (1, 2) index 0
    assert ks.tolist() == [5.0, 4.0]
    assert kp.tolist() == [[1.0, 2.0], [-0.0, 3.0]]
    assert torch.signbit(kp[1, 0])
