"""The port's ``repro_torch.models`` against the JAX package's
``repro.models`` on the CPU, on the reference's seeded batches and its own
parameters (``lm_params_from_numpy`` of ``LM.init(jax.random.key(0))``).

Tolerances, and why:

- The whole model (forward hidden, logits, loss; all ten smoke archs) is
  held against the reference run op by op (``jax.disable_jit()``), whose
  rounding the port follows op for op. Only the order of f32 sums inside a
  matrix product differs, which now and then flips a bf16 rounding (one
  ulp, 2^-8 relative) that the later layers carry: hidden and logits
  within 0.08 of the largest |value|, the reference's own bf16 tolerance
  (``tests/test_models.py::test_decode_matches_forward``), the loss within
  1 % relative. The reference's compiled forward (``lax.scan`` bodies fused
  by XLA, which keeps bf16 intermediates at f32 inside a fusion) differs
  from its own op-by-op run by up to 0.38 (jamba, whose residual stream
  reaches 3e9) and 0.13 (seamless) of the largest |hidden|, so it is not
  the yardstick here.
- Each mixer and FFN alone in f32 (params and input): within 1e-5 of the
  largest |output|, the f32 rounding of sums taken in another order
  (measured at most 3.7e-6). The same in bf16, op by op: within one bf16
  ulp of the largest |output| (2^-8; measured 0).
- MoE routing on the first MoE layer's real input: the same experts, the
  probabilities within 1e-5 (the router's f32 sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_smoke
from repro.models import attention as ja
from repro.models import common as jcommon
from repro.models import mamba as jm
from repro.models import moe as jmoe
from repro.models import rwkv as jr
from repro.models import transformer as jt
from repro_torch import configs as tc
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import LM as TLM
from repro_torch.models import attention as ta
from repro_torch.models import common as tcommon
from repro_torch.models import mamba as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as tr
from repro_torch.models import transformer as tt
from torch_lm_ref import (as_f64, batch, models, rel_err, to_numpy, to_torch,
                          torch_batch)

FORWARD_TOL = 0.08
LOSS_RTOL = 0.01
F32_TOL = 1e-5
BF16_ULP = 2.0 ** -8

_REF = {}


def reference(arch):
    """(port LM, torch batch, the reference's op-by-op hidden, logits,
    loss), computed once a module."""
    if arch not in _REF:
        jlm, params, tlm = models(arch, 0)
        b = batch(jlm.cfg)
        with jax.disable_jit():
            hidden, _ = jlm.forward(params, b, None)
            lg = jlm.logits(params, hidden, None)
            loss, _ = jlm.loss(params, b, None)
        _REF[arch] = (tlm, torch_batch(b), np.asarray(hidden.astype(
            jnp.float32)), np.asarray(lg), float(loss))
    return _REF[arch]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_logits_loss(arch):
    tlm, b, hidden, lg, loss = reference(arch)
    got_h, _ = tlm.forward(b)
    got_lg = tlm.logits(got_h)
    got_loss, _ = tlm.loss(b)
    assert got_h.dtype == torch.bfloat16 and got_lg.dtype == torch.float32
    assert tuple(got_h.shape) == hidden.shape
    assert rel_err(hidden, got_h) < FORWARD_TOL
    assert rel_err(lg, got_lg) < FORWARD_TOL
    assert abs(float(got_loss) - loss) < LOSS_RTOL * abs(loss)
    # the same product on one position: f32 sums in another blocking
    assert rel_err(got_lg[:, -1], tlm.prefill_logits(b)) < F32_TOL


def _p32(tree):
    return jax.tree.map(lambda a: a[0].astype(jnp.float32), tree)


def _p16(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _tp(tree):
    return {k: _tp(v) if isinstance(v, dict) else to_torch(v)
            for k, v in tree.items()}


def _cross(j, p, x, pos, cfg, enc):
    if j:
        return ja.apply_cross(p, x, enc, None, cfg)
    return ta.apply_cross(p, x, enc, None, cfg)


# name: (arch, init, reference apply, port apply); apply(p, x, pos, cfg, enc)
MIXERS = {
    "global": ("qwen3-1.7b", ja.init_gqa,
               lambda p, x, pos, c, e: ja.apply_gqa(p, x, pos, None, c),
               lambda p, x, pos, c, e: ta.apply_gqa(p, x, pos, None, c)),
    "local": ("gemma3-1b", ja.init_gqa,
              lambda p, x, pos, c, e: ja.apply_gqa(p, x, pos, None, c,
                                                   window=c.window),
              lambda p, x, pos, c, e: ta.apply_gqa(p, x, pos, None, c,
                                                   window=c.window)),
    "bidir": ("seamless-m4t-large-v2", ja.init_gqa,
              lambda p, x, pos, c, e: ja.apply_bidir(p, x, pos, None, c),
              lambda p, x, pos, c, e: ta.apply_bidir(p, x, pos, None, c)),
    "cross": ("seamless-m4t-large-v2", ja.init_cross,
              lambda p, x, pos, c, e: _cross(True, p, x, pos, c, e),
              lambda p, x, pos, c, e: _cross(False, p, x, pos, c, e)),
    "mla": ("deepseek-v3-671b", ja.init_mla,
            lambda p, x, pos, c, e: ja.apply_mla(p, x, pos, None, c),
            lambda p, x, pos, c, e: ta.apply_mla(p, x, pos, None, c)),
    "mamba": ("jamba-1.5-large-398b", jm.init_mamba,
              lambda p, x, pos, c, e: jm.apply_mamba(p, x, None, c),
              lambda p, x, pos, c, e: tm.apply_mamba(p, x, None, c)),
    "rwkv": ("rwkv6-7b", jr.init_rwkv_tmix,
             lambda p, x, pos, c, e: jr.apply_rwkv_tmix(p, x, None, c),
             lambda p, x, pos, c, e: tr.apply_rwkv_tmix(p, x, None, c)),
    "cmix": ("rwkv6-7b", jr.init_rwkv_cmix,
             lambda p, x, pos, c, e: jr.apply_rwkv_cmix(p, x, None, c),
             lambda p, x, pos, c, e: tr.apply_rwkv_cmix(p, x, None, c)),
    "moe": ("moonshot-v1-16b-a3b", jmoe.init_moe,
            lambda p, x, pos, c, e: jmoe.apply_moe(p, x, None, c)[0],
            lambda p, x, pos, c, e: tmoe.apply_moe(p, x, None, c)[0]),
    "ffn_glu": ("qwen3-1.7b", jt.init_ffn,
                lambda p, x, pos, c, e: jt.apply_ffn(p, x, None, c),
                lambda p, x, pos, c, e: tt.apply_ffn(p, x, None, c)),
    "ffn_relu2": ("nemotron-4-15b", jt.init_ffn,
                  lambda p, x, pos, c, e: jt.apply_ffn(p, x, None, c),
                  lambda p, x, pos, c, e: tt.apply_ffn(p, x, None, c)),
    "ffn_gelu": ("seamless-m4t-large-v2", jt.init_ffn,
                 lambda p, x, pos, c, e: jt.apply_ffn(p, x, None, c),
                 lambda p, x, pos, c, e: tt.apply_ffn(p, x, None, c)),
}


def _mixer_pair(name, dtype, take):
    arch, init, japply, tapply = MIXERS[name]
    cfg, tcfg = get_smoke(arch), tc.get_smoke(arch)
    col = jcommon.ParamCollector(key=jax.random.key(3))
    init(col, cfg, 1)
    p = take(col.params)
    rng = np.random.default_rng(sorted(MIXERS).index(name))
    B, S = 2, 16
    x = jnp.asarray(rng.normal(0, 1, (B, S, cfg.d_model))).astype(dtype)
    enc = jnp.asarray(rng.normal(0, 1, (B, 12, cfg.d_model))).astype(dtype)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    with jax.disable_jit():
        want = japply(p, x, pos, cfg, enc)
    got = tapply(_tp(p), to_torch(x), to_torch(np.asarray(pos)), tcfg,
                 to_torch(enc))
    return want, got


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_f32(name):
    want, got = _mixer_pair(name, jnp.float32, _p32)
    assert got.dtype == torch.float32
    assert rel_err(want, got) < F32_TOL


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_mixer_bf16(name):
    want, got = _mixer_pair(name, jnp.bfloat16, _p16)
    assert got.dtype == torch.bfloat16
    assert rel_err(want, got) <= BF16_ULP


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_moe_routing_first_layer(arch):
    """The reference's input to its first MoE layer (the blocks before it
    and that block's mixer, op by op), routed by both packages: the same
    experts in the same order, probabilities within F32_TOL (the router's
    f32 sums in another order)."""
    jlm, params, tlm = models(arch, 0)
    cfg = jlm.cfg
    b = batch(cfg)
    i_moe = next(i for i, (_, f) in enumerate(cfg.pattern) if f == "moe")
    gp = jax.tree.map(lambda a: a[0], params["groups"])
    with jax.disable_jit():
        x = jlm._embed_inputs(params, b, None)
        S = x.shape[1]
        pos = jnp.broadcast_to(jnp.arange(S), x.shape[:2])
        aux = jnp.float32(0.0)
        for i, (mixer, ffn) in enumerate(cfg.pattern[:i_moe]):
            x, aux = jt._apply_block(gp[f"blk{i}"], x, aux, mixer, ffn, pos,
                                     None, cfg)
        bp = gp[f"blk{i_moe}"]
        mixer = cfg.pattern[i_moe][0]
        x, _ = jt._apply_block(bp, x, aux, mixer, "none", pos, None, cfg)
        h2 = jcommon.rms_norm(x, bp["ln2"])
        xt = h2.reshape(-1, cfg.d_model)
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", xt.astype(jnp.float32), bp["ffn"]["router"]), -1)
        top_p, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    tp = tlm.params()["groups"][f"blk{i_moe}"]["ffn"]
    t_probs, t_top_p, t_top_e = tmoe.route(
        {"router": tp["router"][0]}, to_torch(xt), tlm.cfg)
    np.testing.assert_array_equal(t_top_e.numpy(), np.asarray(top_e))
    assert rel_err(probs, t_probs) < F32_TOL
    assert rel_err(top_p / jnp.sum(top_p, -1, keepdims=True), t_top_p) \
        < F32_TOL


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_tree(arch):
    """The port's own init draws the reference's tree: every path, shape and
    dtype; ones and zeros where the reference has them, and normal leaves
    of 4096 entries or more with the reference's scale within 10 %."""
    jlm = jt.LM(get_smoke(arch))
    want, _ = jlm.init(jax.random.key(0))
    tlm = TLM(tc.get_smoke(arch))
    got = tlm.init(torch.Generator().manual_seed(0), device="cpu")
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_w) == sum(1 for _ in tlm.parameters())
    for path, w in flat_w.items():
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        wf, gf = as_f64(w), as_f64(g)
        if np.all(wf == wf.flat[0]):
            np.testing.assert_array_equal(gf, wf)
        elif w.size >= 4096:
            assert abs(gf.std() / wf.std() - 1) < 0.1, path


def test_a2a_and_dry_run_helpers_refused():
    """moe_impl="a2a" with rules waits for ROADMAP Queue 1 item 15b, the
    partition-spec helpers for item 15e."""
    cfg = dataclasses.replace(tc.get_smoke("moonshot-v1-16b-a3b"),
                              moe_impl="a2a")
    tlm = TLM(cfg)
    tlm.init(0, device="cpu")
    b = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="15b"):
        tlm.forward(b, tcommon.make_rules())
    tlm.forward(b)  # without rules the GSPMD path runs
    rules = tcommon.make_rules()
    for call in (lambda: tcommon.spec_for(("embed",), rules.param),
                 lambda: tcommon.tree_specs({}, rules.param),
                 lambda: tcommon.tree_specs_for_shapes({}, {}, rules.param,
                                                       rules.sizes),
                 lambda: tlm.param_specs({}, rules)):
        with pytest.raises(NotImplementedError, match="15e"):
            call()


@pytest.mark.parametrize("kw", [{}, {"multi_pod": True}, {"decode": True},
                                {"long_context": True}, {"ep2d": True},
                                {"dp_only": True, "multi_pod": True},
                                {"fsdp": False, "sizes": {"data": 4}}])
def test_rules_tables(kw):
    want, got = jcommon.make_rules(**kw), tcommon.make_rules(**kw)
    assert (got.act, got.param, got.sizes) == (want.act, want.param,
                                                want.sizes)


def test_params_from_numpy_checks_the_tree():
    cfg = get_smoke("qwen3-1.7b")
    params, _ = jt.LM(cfg).init(jax.random.key(0))
    tree = jax.tree.map(to_numpy, params)
    tree["final_ln"] = tree["final_ln"][:-1]
    with pytest.raises(ValueError, match="final_ln"):
        lm_params_from_numpy(tc.get_smoke("qwen3-1.7b"), tree, device="cpu")
    del tree["final_ln"]
    with pytest.raises(ValueError, match="final_ln"):
        lm_params_from_numpy(tc.get_smoke("qwen3-1.7b"), tree, device="cpu")
