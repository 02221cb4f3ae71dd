"""The port's ``ServeEngine.generate`` against the JAX package's on the CPU,
with the reference's parameters (``jax.random.key(4)``) and prompts
(``default_rng(3)``, B = 2, S = 5), 5 new tokens, ``track_topn=10``, as
``tests/test_serve_data.py::test_generate_tracks_global_topn``; on
qwen3-1.7b (the serving launcher's arch) and rwkv6-7b (whose recurrent
state the generate loop advances twice on the last prompt token, as the
reference's does). The reference runs without ``track_topn``: op by op,
its tracking stream's scans take minutes; its trace is the top N of its
candidate wire, which the stream resolves exactly.

Tolerance: each step's logits within 1e-5 of the step's largest |logit|,
against the reference run op by op (``jax.disable_jit()``), whose rounding
the port follows op for op; only the unembedding's f32 sums run in another
order (measured below 2e-7). Greedy tokens are equal at every step up to
the first step where the reference's top-1 margin over the runner-up is
below that tolerance (there the two may part); at least 3 steps are
compared. The trace's values equal the top-N of the port's own candidate
wire bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.models import LM as JLM
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tc
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import engine as tengine
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import ServeEngine, TopNTrace
from torch_lm_ref import to_numpy

LOGIT_TOL = 1e-5
MAX_NEW, TRACK, SHARDS, TOPK = 5, 10, 16, 8


class _RecordingJLM(JLM):
    """The reference's LM, keeping each decode step's logits."""

    def decode_step(self, params, cache, token, pos, rules, enc_out=None):
        lg, cache = super().decode_step(params, cache, token, pos, rules,
                                        enc_out)
        self.seen.append(np.asarray(lg))
        return lg, cache


class _RecordingEngine(ServeEngine):
    """The port's engine, keeping each step's logits and candidate wire."""

    def _step(self, cache, tok, pos):
        lm, logits = self.lm, []
        decode = lm.decode_step

        def spy(*a, **k):
            lg, c = decode(*a, **k)
            logits.append(lg.clone())
            return lg, c

        lm.decode_step = spy
        try:
            tok, cand, cache = super()._step(cache, tok, pos)
        finally:
            del lm.decode_step
        self.logits.append(logits[0])
        self.cands.append(cand)
        return tok, cand, cache


@pytest.fixture(autouse=True)
def _reset_port():
    tengine.reset_caches()
    yield
    tengine.reset_caches()


_RUNS = {}


def run(arch):
    """The reference's and the port's generate on the same parameters and
    prompts, computed once a module."""
    if arch not in _RUNS:
        jlm = _RecordingJLM(get_smoke(arch))
        jlm.seen = []
        params, _ = jlm.init(jax.random.key(4))
        toks = np.random.default_rng(3).integers(
            0, jlm.cfg.vocab, (2, 5)).astype(np.int32)
        with jax.disable_jit():
            want = JEngine(jlm, params, n_logit_shards=SHARDS).generate(
                jnp.asarray(toks), max_new=MAX_NEW)
        tlm = lm_params_from_numpy(tc.get_smoke(arch),
                                   jax.tree.map(to_numpy, params),
                                   device="cpu")
        eng = _RecordingEngine(tlm, n_logit_shards=SHARDS, topk=TOPK,
                               device="cpu")
        eng.logits, eng.cands = [], []
        got, trace = eng.generate(toks, max_new=MAX_NEW, track_topn=TRACK)
        _RUNS[arch] = dict(toks=toks, want=want, jlogits=jlm.seen[-MAX_NEW:],
                           eng=eng, got=got, trace=trace)
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_generate_matches_reference(arch):
    r = run(arch)
    assert r["got"].dtype == np.int32 and r["got"].shape == (2, MAX_NEW)
    compared = 0
    for t in range(MAX_NEW):
        want_lg = r["jlogits"][t]
        got_lg = r["eng"].logits[t].numpy()
        scale = np.abs(want_lg).max()
        assert np.abs(want_lg - got_lg).max() <= LOGIT_TOL * scale, t
        top2 = np.sort(want_lg, axis=1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() < LOGIT_TOL * scale:
            break  # a near tie: the two may part from here on
        np.testing.assert_array_equal(r["got"][:, t], r["want"][:, t])
        compared += 1
    assert compared >= 3
    if compared == MAX_NEW:
        # the reference's trace: lax.top_k of each vocab shard a step (its
        # candidate wire), then the top N of the whole wire
        wire = jnp.concatenate([jax.lax.top_k(
            lg.reshape(2, SHARDS, -1), TOPK)[0].reshape(-1)
            for lg in r["jlogits"]])
        want = np.asarray(jax.lax.top_k(wire, TRACK)[0])
        assert r["trace"].entries == wire.shape[0]
        assert np.abs(r["trace"].values - want).max() \
            <= LOGIT_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_trace_is_the_top_n_of_the_wire(arch):
    r = run(arch)
    trace = r["trace"]
    assert isinstance(trace, TopNTrace)
    wire = torch.cat(r["eng"].cands)
    assert trace.entries == wire.numel() == MAX_NEW * 2 * SHARDS * TOPK
    want = torch.topk(wire, TRACK).values.numpy()
    np.testing.assert_array_equal(trace.values.view(np.int32),
                                  want.view(np.int32))
    assert 0 < trace.shipped <= trace.entries
    assert trace.report is not None


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b"])
def test_tracking_is_passive_and_deterministic(arch):
    r = run(arch)
    eng = ServeEngine(r["eng"].lm, n_logit_shards=SHARDS, device="cpu")
    plain = eng.generate(r["toks"], max_new=MAX_NEW)
    np.testing.assert_array_equal(plain, r["got"])
    np.testing.assert_array_equal(eng.generate(r["toks"], max_new=MAX_NEW),
                                  plain)


def test_launch_serve_on_the_cpu(capsys):
    """The launcher's path: 8 requests of which 3 are fresh, through the
    RequestCache, then generate."""
    out = tlaunch.main(["--device", "cpu", "--max-new", "3"])
    assert out.shape == (3, 3) and out.dtype == np.int32
    assert "8 requests -> 3 after dedup" in capsys.readouterr().out


def test_engine_runs_where_its_model_is():
    tlm = run("qwen3-1.7b")["eng"].lm
    with pytest.raises(ValueError, match="parameters are on cpu"):
        ServeEngine(tlm, device="meta")
