"""The port's §7.2 reliability protocol (``repro_torch.query.protocol``)
against the JAX package's (``repro.query.protocol``), on the CPU.

The cases of ``tests/test_protocol.py`` as parity cases: the state
machines' actions on the same packet sequences, and ``simulate_lossy_stream``
/ ``simulate_lossy_stream_multi`` giving equal dicts (the same draws in the
same order) for keep masks given as numpy arrays and as torch tensors, with
the multi-query masks from both packages' ``engine_prune_batch``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import query as jquery
from repro_torch import core as tcore
from repro_torch import query as tquery

DROPS = (0.0, 0.05, 0.2, 0.35)
SEEDS = (0, 1, 7)


def _sequence(sw, fn):
    """The reference test's packets, then a gap, a retransmission, the gap
    closed and a late duplicate."""
    seqs = list(range(6)) + [8, 3, 6, 7, 8, 2, 9, 12]
    return [sw.on_packet(s, fn) for s in seqs] + [sw.last_seq]


def test_state_machine_sequence():
    for fn in (lambda s: s % 2 == 0, lambda s: s % 3 == 1, lambda s: True):
        assert _sequence(tquery.SwitchReliability(), fn) == \
            _sequence(jquery.SwitchReliability(), fn)


def test_multi_query_state_machine_sequence():
    def run(cls):
        calls = []
        fns = [lambda s: calls.append(("a", s)) or s % 2 == 0,
               lambda s: calls.append(("b", s)) or s % 3 != 0]
        return _sequence(cls(), fns), calls

    assert run(tquery.MultiQuerySwitchReliability) == \
        run(jquery.MultiQuerySwitchReliability)


def test_combined_forward_mask():
    kb = np.array([[1, 0, 0, 1], [0, 0, 1, 1]], bool)
    want = jquery.combined_forward_mask(kb)
    np.testing.assert_array_equal(tquery.combined_forward_mask(kb), want)
    np.testing.assert_array_equal(
        tquery.combined_forward_mask(torch.from_numpy(kb)), want)


def _distinct_case(seed, m=60):
    rs = np.random.default_rng(seed)
    vals = rs.integers(0, 10, m).astype(np.uint32)
    keep = np.array(jcore.distinct_prune(jnp.asarray(vals), d=8, w=2).keep)
    return vals, keep


@pytest.mark.parametrize("drop", DROPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_lossy_stream_equal(drop, seed):
    vals, keep = _distinct_case(seed)
    want = jquery.simulate_lossy_stream(vals.tolist(), keep, drop_prob=drop,
                                        seed=seed, max_rounds=5000)
    tkeep = tcore.distinct_prune(torch.from_numpy(vals), d=8, w=2).keep
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    for mask in (keep, tkeep):
        got = tquery.simulate_lossy_stream(vals.tolist(), mask,
                                           drop_prob=drop, seed=seed,
                                           max_rounds=5000)
        assert got == want
    assert want["delivered_all"]
    # superset safety: retransmitted pruned packets leave DISTINCT as it is
    mask = np.zeros(vals.size, bool)
    mask[want["master_indices"]] = True
    out = tcore.master_complete_distinct(torch.from_numpy(vals),
                                         torch.from_numpy(mask))
    assert set(vals[out.numpy()].tolist()) == set(vals.tolist())


@pytest.mark.parametrize("max_rounds", [1, 3])
def test_lossy_stream_cut_short(max_rounds):
    """A run that stops at ``max_rounds`` with packets unacknowledged."""
    vals, keep = _distinct_case(3, m=200)
    want = jquery.simulate_lossy_stream(vals, keep, drop_prob=0.3, seed=3,
                                        max_rounds=max_rounds)
    got = tquery.simulate_lossy_stream(vals, torch.from_numpy(keep),
                                       drop_prob=0.3, seed=3,
                                       max_rounds=max_rounds)
    assert got == want and not got["delivered_all"]


QUERIES = [dict(d=16, w=4, policy="lru", seed=0),
           dict(d=8, w=2, policy="lru", seed=3),
           dict(d=32, w=3, policy="lru", seed=5)]


@pytest.mark.parametrize("mode", ["scan", "two_pass"])
@pytest.mark.parametrize("drop", [0.0, 0.02, 0.3])
def test_multi_query_lossy_equal(mode, drop):
    """The protocol over Q = 3 DISTINCT queries' batched keep masks."""
    m, seed = 300, 11
    vals = np.random.default_rng(seed).zipf(1.3, m).astype(np.uint32) % 97
    kw = dict(mode=mode, shards=8) if mode == "two_pass" else dict(mode=mode)
    jkeep = np.asarray(jcore.engine_prune_batch(
        "distinct", QUERIES, jnp.asarray(vals), **kw).keep)
    tkeep = tcore.engine_prune_batch("distinct", QUERIES,
                                     torch.from_numpy(vals), **kw).keep
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    want = jquery.simulate_lossy_stream_multi(vals.tolist(), jkeep,
                                              drop_prob=drop, seed=seed,
                                              max_rounds=5000)
    for kb in (jkeep, tkeep):
        got = tquery.simulate_lossy_stream_multi(vals.tolist(), kb,
                                                 drop_prob=drop, seed=seed,
                                                 max_rounds=5000)
        assert got == want
    got_set = set(want["master_indices"])
    for q in range(len(QUERIES)):
        assert set(np.nonzero(jkeep[q])[0].tolist()) <= got_set
    mask = np.zeros(m, bool)
    mask[want["master_indices"]] = True
    out = tcore.master_complete_distinct(torch.from_numpy(vals),
                                         torch.from_numpy(mask))
    assert set(vals[out.numpy()].tolist()) == set(vals.tolist())
