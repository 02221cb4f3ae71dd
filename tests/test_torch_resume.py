"""Scan resume: each core function of the port, its stream split at ragged
points, against the JAX package's resumed scan.

Every piece starts from the reference's carried state, carried into the
port with ``repro_torch.convert``, so that each piece is held on its own:
keep and the state after it must be bit-identical (f32 by their bits).
A chained run of the port on its own states ends in the same state. The
JAX references are computed once a module (``_jax_pieces``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro_torch import convert
from repro_torch import core as T

CUTS = (0, 137, 641, 1500)
M = CUTS[-1]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(t, j):
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(j))


def _stream(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "values":
        x = rng.gamma(2.0, 50.0, M).astype(np.float32)
        x[rng.random(M) < 0.02] = 0.0
        return (x,)
    if kind == "keys":
        return (rng.integers(0, 300, M).astype(np.uint32),)
    if kind == "points":
        return (rng.gamma(2.0, 20.0, (M, 3)).astype(np.float32),)
    return (rng.integers(0, 90, M).astype(np.uint32),
            rng.integers(1, 60, M).astype(np.int32))


# (name, stream kind, JAX call, port call, fields of the state)
CASES = {
    "topn_rand": ("values", dict(d=32, w=3), ("vals",)),
    "topn_det": ("values", dict(N=200, w=6),
                 ("t0", "counts", "seen", "cur_level")),
    "topn_det_long_warm": ("values", dict(N=1000, w=4),
                           ("t0", "counts", "seen", "cur_level")),
    "distinct_fifo": ("keys", dict(d=16, w=4, policy="fifo"),
                      ("slots", "valid", "head")),
    "distinct_lru": ("keys", dict(d=16, w=4, policy="lru"),
                     ("slots", "valid", "head")),
    "skyline_aph": ("points", dict(w=6, score="aph"), ("points", "scores")),
    "skyline_sum": ("points", dict(w=6, score="sum"), ("points", "scores")),
    "groupby_sum": ("pairs", dict(d=8, w=3, agg="sum"),
                    ("keys", "aggs", "valid")),
    "groupby_count": ("pairs", dict(d=8, w=3, agg="count"),
                      ("keys", "aggs", "valid")),
    "having_count": ("pairs", dict(agg="count", threshold=20, rows=3,
                                   width=64), ("table",)),
    "having_sum_f32": ("pairs", dict(agg="sum", threshold=300.5, rows=2,
                                     width=32), ("table",)),
}
OFFSET_WRAP = (1 << 32) - 5   # topn_rand's index offset, wrapping mid-stream


def _algo(name: str) -> str:
    for a in ("topn_rand", "topn_det", "distinct", "skyline", "groupby",
              "having"):
        if name.startswith(a):
            return a
    raise KeyError(name)


def _jax_call(name, piece, params, state, offset):
    algo = _algo(name)
    p = {k: v for k, v in params.items() if k != "threshold"}
    if algo == "topn_rand":
        return J.topn_rand_prune(jnp.asarray(piece[0]), state=state,
                                 index_offset=np.uint32(offset % (1 << 32)),
                                 **p)
    if algo == "topn_det":
        return J.topn_det_prune(jnp.asarray(piece[0]), state=state, **p)
    if algo == "distinct":
        return J.distinct_prune(jnp.asarray(piece[0]), state=state, **p)
    if algo == "skyline":
        return J.skyline_prune(jnp.asarray(piece[0]), state=state, **p)
    if algo == "groupby":
        return J.groupby_prune(jnp.asarray(piece[0]), jnp.asarray(piece[1]),
                               state=state, **p)
    vals = piece[1].astype(np.float32) if name.endswith("f32") else piece[1]
    return J.having_prune(jnp.asarray(piece[0]), jnp.asarray(vals),
                          params["threshold"], state=state, **p)


def _port_call(name, piece, params, state, offset):
    algo = _algo(name)
    p = {k: v for k, v in params.items() if k != "threshold"}
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in piece]
    if algo == "topn_rand":
        return T.topn_rand_prune(t[0], state=state, index_offset=offset, **p)
    if algo == "topn_det":
        return T.topn_det_prune(t[0], state=state, **p)
    if algo == "distinct":
        return T.distinct_prune(t[0], state=state, **p)
    if algo == "skyline":
        return T.skyline_prune(t[0], state=state, **p)
    if algo == "groupby":
        return T.groupby_prune(t[0], t[1], state=state, **p)
    vals = t[1].to(torch.float32) if name.endswith("f32") else t[1]
    return T.having_prune(t[0], vals, params["threshold"], state=state, **p)


def _to_port(name, jstate):
    """The reference's carried state as the port's (``convert``)."""
    if jstate is None:
        return None
    algo = _algo(name)
    a = {f: np.asarray(v) for f, v in vars(jstate).items()
         if not isinstance(v, int)}
    dev = "cpu"
    if algo == "topn_rand":
        return convert.topn_rand_state_from_numpy(a["vals"], device=dev)
    if algo == "topn_det":
        return convert.topn_det_state_from_numpy(**a, device=dev)
    if algo == "distinct":
        return convert.distinct_state_from_numpy(**a, device=dev)
    if algo == "skyline":
        return convert.skyline_state_from_numpy(**a, device=dev)
    if algo == "groupby":
        return convert.groupby_state_from_numpy(**a, device=dev)
    return convert.count_min_from_numpy(a["table"], seed=jstate.seed,
                                        device=dev)


@functools.lru_cache(maxsize=None)
def _jax_pieces(name: str, base: int):
    """The reference's resumed scan over the pieces: per piece (the state
    it starts from, its keep, the state after it, its emissions)."""
    kind, params, _ = CASES[name]
    streams = _stream(kind, 1)
    out, state, off = [], None, base
    for lo, hi in zip(CUTS, CUTS[1:]):
        piece = tuple(s[lo:hi] for s in streams)
        r = _jax_call(name, piece, params, state, off)
        out.append((state, piece, off, np.asarray(r.keep), r.state,
                    None if r.emitted is None
                    else tuple(np.asarray(e) for e in r.emitted)))
        state, off = r.state, off + (hi - lo)
    return tuple(out)


def _state_eq(name, tstate, jstate):
    for f in CASES[name][2]:
        _eq(getattr(tstate, f), getattr(jstate, f))


PIECE_CASES = [(n, 0) for n in CASES] + [("topn_rand", OFFSET_WRAP)]


@pytest.mark.parametrize("name,base", PIECE_CASES)
def test_each_piece_from_the_reference_state(name, base):
    """Each ragged piece resumed from the reference's carried state gives
    the reference's keep and state bit for bit, and leaves the carried
    state it was given as it was."""
    params = CASES[name][1]
    for jstart, piece, off, jkeep, jafter, jemit in _jax_pieces(name, base):
        start = _to_port(name, jstart)
        before = (None if start is None else
                  {f: getattr(start, f).clone() for f in CASES[name][2]})
        r = _port_call(name, piece, params, start, off)
        _eq(r.keep, jkeep)
        _state_eq(name, r.state, jafter)
        if jemit is not None:
            for t, j in zip(r.emitted, jemit):
                _eq(t, j)
        if before is not None:
            for f, v in before.items():
                assert torch.equal(getattr(start, f), v)


@pytest.mark.parametrize("name,base", PIECE_CASES)
def test_chained_resume_ends_in_the_reference_state(name, base):
    """The port's resumed scan on its own carried states, piece after piece,
    ends in the reference's state and keeps what it keeps."""
    params = CASES[name][1]
    pieces = _jax_pieces(name, base)
    state = None
    for _, piece, off, jkeep, jafter, _ in pieces:
        r = _port_call(name, piece, params, state, off)
        _eq(r.keep, jkeep)
        state = r.state
    _state_eq(name, state, pieces[-1][4])


def test_index_offset_wraps_as_uint32():
    """An offset past 2^32 hashes as its value mod 2^32, as the reference's
    uint32 add wraps: the port takes the offset as an int either way."""
    x = _stream("values", 3)[0][:300]
    a = T.topn_rand_prune(torch.from_numpy(x), d=16, w=2,
                          index_offset=OFFSET_WRAP + 7)
    b = T.topn_rand_prune(torch.from_numpy(x), d=16, w=2,
                          index_offset=OFFSET_WRAP + 7 + (1 << 32))
    j = J.topn_rand_prune(jnp.asarray(x), d=16, w=2,
                          index_offset=np.uint32(2))
    _eq(a.keep, j.keep)
    _eq(b.keep, j.keep)
    _eq(a.state.vals, j.state.vals)


def test_block_kernels_refuse_a_carried_state():
    """Only the one-entry passes resume (the reference has no resumed block
    kernel): a B > 1 call with a state, or the kernels' family, raises."""
    from repro_torch.kernels import parallel as P

    x = torch.zeros(64)
    st = torch.full((1, 4, 2), -1.0)
    with pytest.raises(ValueError, match="one-entry"):
        P.topn_shard_states_kernel(x, d=4, w=2, shards=1, block=8,
                                   family="engine", state=st)
    with pytest.raises(ValueError, match="one-entry"):
        P.topn_shard_states_kernel(x, d=4, w=2, shards=1, block=1,
                                   index_offset=3)
    k = torch.zeros(64, dtype=torch.int32).view(torch.uint32)
    dst = (torch.zeros((1, 4, 2), dtype=torch.uint32),
           torch.zeros((1, 4, 2), dtype=torch.bool),
           torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="one-entry"):
        P.distinct_shard_states_kernel(k, d=4, w=2, shards=1, block=8,
                                       state=dst)
    with pytest.raises(ValueError, match="carried state"):
        P.distinct_shard_states_kernel(k, d=4, w=2, shards=1, block=1,
                                       state=dst[:2] + (dst[2][:, :2],))
