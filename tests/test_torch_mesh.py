"""The port's mesh mode (``engine_prune(mode="mesh")``, ``core.mesh``)
against the JAX package's, on the CPU.

The reference runs on the conftest's 8 CPU devices (a ``jax.sharding.Mesh``
over them, ``shard_map`` inside), the port on ``Mesh(("cpu",) * 8)``: 8
positions of S/8 lanes each, every apply on its lanes with their global
lane base. The same numpy-seeded streams go through both; with tolerance 0
the keep, the merged state, the emissions and the report's mesh counters
must be the reference's mesh call's, at both pass-2 placements of the port
(the resident keep stacked [S, n], flattened by ``unshard_mask``), and the
keep must be the port's own ``two_pass`` at the same S. The reference's
two placements give the same keep, state and emissions (its own
``tests/test_mesh_engine.py``), so each case's reference is its mesh call
at ``pass2="master"``, run once a module (``_jax``); one resident reference
call holds the stacked layout and DISTINCT's global lane ranks.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import planner as jplanner
from repro_torch import core as T
from repro_torch.core import engine as tengine
from repro_torch.core import mesh as tmesh
from repro_torch.core import planner as tplanner

S = 16
POSITIONS = 8
M = 2048
RAGGED = 2001
CASES = {
    "topn_det": ("topn_det", dict(N=25, w=8)),
    "topn_rand": ("topn_rand", dict(d=64, w=4)),
    "distinct_fifo": ("distinct", dict(d=32, w=4, policy="fifo")),
    "distinct_lru": ("distinct", dict(d=32, w=4)),
    "skyline": ("skyline", dict(w=8)),
    "having": ("having", dict(threshold=20, rows=3, width=256, agg="count")),
    "groupby": ("groupby", dict(d=16, w=4, agg="sum")),
}


@pytest.fixture(autouse=True)
def _reset_port():
    """The port's calibration, reset around each test (the shared conftest
    resets the JAX package's)."""
    tengine.reset_caches()
    yield
    tengine.reset_caches()


def _streams(algo, m, seed=0):
    rng = np.random.default_rng(seed)
    if algo in ("topn_det", "topn_rand"):
        return (rng.random(m).astype(np.float32) * 1e4 + 1,)
    if algo == "distinct":
        return (rng.integers(1, 300, m).astype(np.uint32),)
    if algo == "skyline":
        return (rng.random((m, 3)).astype(np.float32) * 100,)
    if algo == "having":
        return (rng.integers(0, 64, m).astype(np.uint32),
                rng.integers(1, 9, m).astype(np.int32))
    return (rng.integers(0, 64, m).astype(np.uint32),
            (rng.random(m) * 10).astype(np.float32))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(t, j):
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def _state_eq(tstate, jstate):
    for f in vars(jstate):
        jv = getattr(jstate, f)
        if isinstance(jv, int):
            assert getattr(tstate, f) == jv
        else:
            _eq(getattr(tstate, f), jv)


def _jmesh(n=POSITIONS):
    return jengine.default_mesh("shards", n)


@functools.lru_cache(maxsize=None)
def _jax(case, m, seed=0):
    algo, params = CASES[case]
    xs = _streams(algo, m, seed)
    res = jengine.engine_prune(algo, *map(jnp.asarray, xs), mode="mesh",
                               shards=S, mesh=_jmesh(), pass2="master",
                               **params)
    return xs, res


def _port(case, xs, pass2, shards=S, mesh=None, **kw):
    algo, params = CASES[case]
    mesh = mesh or T.Mesh(("cpu",) * POSITIONS)
    return T.engine_prune(algo, *map(torch.from_numpy, xs), mode="mesh",
                          shards=shards, mesh=mesh, pass2=pass2,
                          **kw, **params)


# every case at M, and a ragged m (tail pads; GROUP BY's validity column)
# for two of them
MESH_CASES = [(c, M) for c in CASES] + [("distinct_lru", RAGGED),
                                        ("groupby", RAGGED)]


@pytest.mark.parametrize("pass2", ["master", "mesh"])
@pytest.mark.parametrize("case,m", MESH_CASES)
def test_mesh_matches_the_reference(case, m, pass2):
    xs, jres = _jax(case, m)
    res = _port(case, xs, pass2)
    flat = res.keep
    if pass2 == "mesh":
        assert res.keep.shape == (S, -(-m // S))
        flat = T.unshard_mask(res.keep, m)
    _eq(flat, jres.keep)
    _state_eq(res.state, jres.state)
    if jres.emitted is None:
        assert res.emitted is None
    else:
        for t, j in zip(res.emitted, jres.emitted):
            _eq(t, j)
    got, want = res.report.counters, jres.report.counters
    for k in ("merge_collective_count", "entries_scanned", "entries_kept"):
        assert got[k] == want[k], k
    # the resident gather ships S lanes' states to each of the D positions
    assert got["state_bytes_shipped"] == want["state_bytes_shipped"] * (
        POSITIONS if pass2 == "mesh" else 1)
    assert res.report.meta["num_devices"] == POSITIONS
    algo, params = CASES[case]
    two = T.engine_prune(algo, *map(torch.from_numpy, xs), mode="two_pass",
                         shards=S, obs="off", **params)
    assert torch.equal(flat, two.keep)


@pytest.mark.parametrize("case", ["distinct_fifo", "skyline"])
def test_chunked_resident_apply_equals_unchunked(case):
    xs, jres = _jax(case, M)
    whole = _port(case, xs, "mesh", apply_block=1 << 20)
    for block in (32, 100):
        res = _port(case, xs, "mesh", apply_block=block)
        assert torch.equal(res.keep, whole.keep)
    _eq(T.unshard_mask(whole.keep, M), jres.keep)


N_LANE = M // S
AT_777 = [N_LANE * 13 - 1] + [lane * N_LANE + 3 for lane in (13, 14, 15)]


def _owner_up_high(seed=5):
    """DISTINCT lanes of M / S entries where 777, the last entry of lane 12
    (position 6 of 8, two lanes a position), stays in its cache and occurs
    again in lanes 13 to 15: only the lanes' global ranks tell that a lower
    lane owns it."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 300, M).astype(np.uint32)
    x[AT_777] = 777
    return (x,)


def test_resident_distinct_reads_global_lane_ranks():
    xs = _owner_up_high()
    params = CASES["distinct_fifo"][1]
    jres = jengine.engine_prune("distinct", jnp.asarray(xs[0]), mode="mesh",
                                shards=S, mesh=_jmesh(), pass2="mesh",
                                **params)
    res = T.engine_prune("distinct", torch.from_numpy(xs[0]), mode="mesh",
                         shards=S, mesh=T.Mesh(("cpu",) * POSITIONS),
                         pass2="mesh", **params)
    assert res.keep.shape == np.shape(jres.keep) == (S, N_LANE)
    _eq(res.keep, jres.keep)
    flat = T.unshard_mask(res.keep, M)
    assert flat[AT_777].tolist() == [True, False, False, False]
    two = T.engine_prune("distinct", torch.from_numpy(xs[0]),
                         mode="two_pass", shards=S, **params)
    assert torch.equal(flat, two.keep)


def test_distinct_apply_lane_base():
    """The apply kernel's plain version over one position's lanes, with
    its lane base, is that position's slice of the whole apply."""
    from repro_torch.kernels import parallel as tpar

    (x,) = _owner_up_high()
    x = torch.from_numpy(x)
    d, w, n, L = 32, 4, N_LANE, 2
    keep1, sl, va, _ = tpar.distinct_shard_states_kernel(
        x, d=d, w=w, shards=S, block=1, policy="fifo")
    ms, mv = tpar.merge_distinct_states(sl, va)
    whole = tpar.distinct_apply_kernel(x, keep1, ms, mv, d=d, shards=S)
    parts = [tpar.distinct_apply_kernel(
        x[g0 * n:(g0 + L) * n].contiguous(),
        keep1[g0 * n:(g0 + L) * n].contiguous(), ms, mv, d=d, shards=L,
        lane0=g0, w=w) for g0 in range(0, S, L)]
    assert torch.equal(torch.cat(parts), whole)
    with pytest.raises(ValueError, match="lane0"):
        tpar.distinct_apply_kernel(x[:L * n], keep1[:L * n], ms, mv, d=d,
                                   shards=L, lane0=S - 1, w=w)


def test_divisor_submesh_and_divisibility(monkeypatch):
    """S = 6 over at most 8 positions: the largest divisor, 6, as the
    reference's submesh; an explicit mesh that does not divide S raises the
    reference's error."""
    assert tengine._mesh_for_shards(6, "shards", "cpu").shape == \
        {"shards": 1}
    with monkeypatch.context() as mp:   # the reference's 8 devices
        mp.setattr(tengine, "default_positions", lambda device: 8)
        assert tengine._mesh_for_shards(6, "shards", "cpu").shape == \
            {"shards": 6}
    assert jengine._mesh_for_shards(6, "shards").shape["shards"] == 6
    xs = _streams("topn_det", RAGGED)
    jres = jengine.engine_prune("topn_det", jnp.asarray(xs[0]), mode="mesh",
                                shards=6, N=25, w=8)
    res = T.engine_prune("topn_det", torch.from_numpy(xs[0]), mode="mesh",
                         shards=6, N=25, w=8)
    _eq(res.keep, jres.keep)
    msgs = []
    for eng, x, mesh in ((tengine, torch.from_numpy(xs[0]),
                          T.Mesh(("cpu",) * 4)),
                         (jengine, jnp.asarray(xs[0]), _jmesh(4))):
        with pytest.raises(ValueError) as e:
            eng.engine_prune("topn_det", x, mode="mesh", shards=6, mesh=mesh,
                             N=25, w=8)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("overhead", [None, 0.0])
@pytest.mark.parametrize("case", ["topn_det", "distinct_lru", "skyline"])
def test_pass2_auto_follows_optimal_pass2(case, overhead, monkeypatch):
    """pass2="auto" places pass 2 where planner.optimal_pass2 says, over S x
    one lane's state bytes, in both packages (without the fixed resident
    overhead the resident pass 2 wins at this m)."""
    if overhead is not None:
        monkeypatch.setattr(tplanner, "RESIDENT_OVERHEAD_ENTRIES", overhead)
        monkeypatch.setattr(jplanner, "RESIDENT_OVERHEAD_ENTRIES", overhead)
    algo, params = CASES[case]
    xs, jres = _jax(case, M)
    res = _port(case, xs, "auto")
    lanes = tuple(tengine.shard_stack(torch.from_numpy(x), S) for x in xs)
    per_lane = tengine._per_shard_state_bytes(tengine._SPECS[algo], lanes,
                                              params)
    jlanes = tuple(jengine.shard_stack(jnp.asarray(x), S) for x in xs)
    assert per_lane == jengine._per_shard_state_bytes(
        jengine._SPECS[algo], jlanes, params)
    want = tplanner.optimal_pass2(M, POSITIONS, S * per_lane)
    assert want == jplanner.optimal_pass2(M, POSITIONS, S * per_lane)
    assert want == ("mesh" if overhead == 0.0 else "master")
    assert res.keep.ndim == (2 if want == "mesh" else 1)
    assert res.report.meta["pass2"] == "auto"
    _eq(T.unshard_mask(res.keep, M), jres.keep)


@pytest.mark.parametrize("case", ["groupby", "having"])
def test_state_bytes_of_every_form(case):
    """One lane's state bytes from an empty lane state, as the reference's
    shape-only probe of pass 1 counts them."""
    algo, params = CASES[case]
    xs = _streams(algo, M)
    lanes = tuple(tengine.shard_stack(torch.from_numpy(x), S) for x in xs)
    jlanes = tuple(jengine.shard_stack(jnp.asarray(x), S) for x in xs)
    assert tengine._per_shard_state_bytes(tengine._SPECS[algo], lanes,
                                          params) == \
        jengine._per_shard_state_bytes(jengine._SPECS[algo], jlanes, params)


@pytest.mark.parametrize("pass2", ["master", "mesh"])
def test_one_lane_mesh_keeps_the_mesh_contract(pass2):
    """S = 1: the one-lane mesh still merges, and a resident keep is the
    stacked [1, m] (the reference's resident call, run once)."""
    xs, jres = _one_lane()
    res = T.engine_prune("topn_rand", torch.from_numpy(xs[0]), mode="mesh",
                         shards=1, mesh=T.Mesh(("cpu",)), pass2=pass2, d=64,
                         w=4)
    if pass2 == "mesh":
        assert res.keep.shape == tuple(np.shape(jres.keep)) == (1, RAGGED)
    _eq(res.keep.reshape(-1), np.asarray(jres.keep).reshape(-1))
    _state_eq(res.state, jres.state)


@functools.lru_cache(maxsize=None)
def _one_lane():
    xs = _streams("topn_rand", RAGGED)
    return xs, jengine.engine_prune("topn_rand", jnp.asarray(xs[0]),
                                    mode="mesh", shards=1, pass2="mesh",
                                    d=64, w=4)


def test_shards_none_and_auto_follow_the_mesh():
    """shards=None is one lane a position; "auto" rounds the planner's S up
    to a multiple of the positions, as in the reference."""
    x = _streams("topn_det", M)[0]
    mesh = T.Mesh(("cpu",) * 4)
    res = T.engine_prune("topn_det", torch.from_numpy(x), mode="mesh",
                         mesh=mesh, N=25, w=8)
    assert res.report.meta["shards"] == 4
    c, sb = tengine.calibrate_merge_cost("topn_det", (torch.from_numpy(x),),
                                         dict(N=25, w=8))
    s = tplanner.optimal_shards(M, sb, merge_byte_cost=c)
    res = T.engine_prune("topn_det", torch.from_numpy(x), mode="mesh",
                         mesh=mesh, shards="auto", N=25, w=8)
    assert res.report.meta["shards"] == max(-(-s // 4) * 4, 4)


def test_mesh_class_and_default_mesh():
    """The positions own contiguous lanes; default_mesh on the CPU repeats
    the CPU; without a card default_mesh refuses rather than falls back."""
    mesh = T.Mesh(("cpu",) * 4, axis="data")
    assert mesh.shape == {"data": 4} and mesh.world == 1
    assert [g0 for _, g0 in mesh.positions(3)] == [0, 3, 6, 9]
    assert T.default_mesh(device="cpu").devices == (torch.device("cpu"),)
    assert T.default_mesh("data", 3, device="cpu").shape == {"data": 3}
    assert tmesh.default_positions("cpu") == 1
    with pytest.raises(ValueError):
        T.Mesh(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.default_mesh()
    got = mesh.all_gather([torch.arange(2), torch.arange(2, 5)])
    assert got.tolist() == [0, 1, 2, 3, 4]
    assert mesh.all_reduce([torch.ones(3, dtype=torch.int32)] * 4).tolist() \
        == [4, 4, 4]
    assert mesh.collectives == 2
