"""The port's decode path against the JAX package's on the CPU: the six
archs of the reference's ``test_decode_matches_forward``
(``tests/test_models.py:43-46``: the GQA cache, the local ring buffer, RWKV
state, Mamba state, MLA's absorbed decode, the enc-dec cross cache), the
reference's parameters from ``jax.random.key(1)`` and its batch of seed 1
(B = 2, S = 12; gemma3-1b's window of 8 wraps its ring).

Tolerance: 0.08 of the largest |logit|, the reference's own for two bf16
paths through one model (0.12 for jamba, as the reference's, where
discrete MoE routing amplifies bf16 noise across 8 hybrid layers). The
port's prefill-via-decode logits are held to the reference's
``prefill_via_decode`` as it runs (its compiled ``lax.scan``), and to the
port's own forward as the reference holds its own.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_smoke
from repro.models import LM as JLM
from repro_torch import configs as tc
from repro_torch.models import LM as TLM
from torch_lm_ref import batch, models, rel_err, to_torch, torch_batch

DECODE_ARCHS = ["qwen3-1.7b", "gemma3-1b", "rwkv6-7b", "jamba-1.5-large-398b",
                "deepseek-v3-671b", "seamless-m4t-large-v2"]
B, S = 2, 12


def _tol(arch):
    return 0.12 if arch.startswith("jamba") else 0.08


@pytest.fixture(scope="module")
def runs():
    """arch -> (port LM, torch batch, the reference's last prefill-via-
    decode logits), computed once a module."""
    out = {}
    for arch in DECODE_ARCHS:
        jlm, params, tlm = models(arch, 1)
        b = batch(jlm.cfg, B, S, seed=1)
        cache, _ = jlm.init_cache(B, S + 4)
        if jlm.cfg.n_enc_layers:
            enc_out = jlm.encode(params, b["frame_embeds"], None)
            cache["cross"] = jlm.build_cross_cache(params, enc_out)
        last, _ = jlm.prefill_via_decode(params, cache, b["tokens"], None)
        out[arch] = (tlm, torch_batch(b), np.asarray(last))
    return out


def _prefill(tlm, b):
    cache = tlm.init_cache(B, S + 4)
    if tlm.cfg.n_enc_layers:
        cache["cross"] = tlm.build_cross_cache(tlm.encode(b["frame_embeds"]))
    return tlm.prefill_via_decode(cache, b["tokens"])


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_via_decode_matches_reference(arch, runs):
    tlm, b, want = runs[arch]
    got, _ = _prefill(tlm, b)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_err(want, got) < _tol(arch)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch, runs):
    """The reference's own test on the port: last-token logits from the
    cache path equal the full forward's."""
    tlm, b, _ = runs[arch]
    hidden, _ = tlm.forward(b)
    full = tlm.logits(hidden)[:, -1]
    got, _ = _prefill(tlm, b)
    assert rel_err(full, got) < _tol(arch)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_layout(arch):
    """init_cache holds the reference's leaves: the same paths, shapes and
    dtypes (a local mixer's ring buffer of min(window, max_len) slots)."""
    want, _ = JLM(get_smoke(arch)).init_cache(3, 10)
    tlm = TLM(tc.get_smoke(arch))
    tlm.init(0, device="meta")
    got = tlm.init_cache(3, 10)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat:
        g = got
        for k in path:
            g = g[k.key]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    assert len(jax.tree.leaves(got)) == len(flat)


def test_ring_buffer_positions():
    """gemma3-1b's local layers after 12 decoded tokens at window 8: slot
    pos % 8 holds position pos, as the reference's ring."""
    tlm = TLM(tc.get_smoke("gemma3-1b"))
    tlm.init(0, device="cpu")
    cache = tlm.init_cache(1, 16)
    tokens = to_torch(np.arange(12, dtype=np.int32)[None] % 500)
    tlm.prefill_via_decode(cache, tokens)
    kpos = cache["groups"]["blk0"]["kpos"][0, 0]
    np.testing.assert_array_equal(kpos.numpy(),
                                  [8, 9, 10, 11, 4, 5, 6, 7])
