"""Model assembly: the pattern-blocked transformer stack for all 10 archs.

Layers are grouped by the arch's repeating pattern (gemma3's 5 local + 1
global, jamba's 1 attention + 7 Mamba) with the parameters of a pattern
position stacked over groups: ``groups.blk0.mixer.wq`` is [G, d, H*dh], as
in the reference's tree. A Python loop over groups takes the place of the
reference's ``lax.scan``s; a non-divisible remainder runs as a "tail".
Encoder-decoder (seamless) wires a bidirectional encoder stack and a
causal decoder with cross-attention.

``LM`` is an ``nn.Module`` whose parameters are registered under those
tree paths. Entry points: ``init``, ``forward``, ``logits``, ``loss``,
``init_cache``, ``decode_step``, ``prefill_logits``,
``prefill_via_decode``, ``encode`` and ``build_cross_cache``. They compute
values only (no gradient in this slice). Decode updates the cache in
place and returns it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import attention as attn
from . import mamba as mam
from . import moe as moe_mod
from . import rwkv as rwk
from .common import (ACTIVATIONS, ParamCollector, Rules, constrain, dense,
                     einsum32, f32, index_tree, rms_norm, scalar,
                     softmax)

_A2A = ("the all-to-all MoE island (moe_impl='a2a' with rules) is not "
        "ported yet (ROADMAP Queue 1 item 15b)")


# ------------------------------------------------------------- dense FFN
def init_ffn(col: ParamCollector, cfg, L: int) -> None:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.ffn_glu:
        col.param("wi_gate", (L, d, ff))
        col.param("wi_up", (L, d, ff))
    else:
        col.param("wi", (L, d, ff))
    col.param("wo", (L, ff, d))


def apply_ffn(p, x, rules, cfg):
    act = ACTIVATIONS[cfg.act]
    if cfg.ffn_glu:
        h = act(dense(x, p["wi_gate"])) * dense(x, p["wi_up"])
    else:
        h = act(dense(x, p["wi"]))
    return constrain(dense(h, p["wo"]), ("batch", "seq", "embed"), rules)


# ------------------------------------------------------------ block init
_MIXER_INIT = {
    "global": attn.init_gqa, "local": attn.init_gqa, "bidir": attn.init_gqa,
    "mla": attn.init_mla, "mamba": mam.init_mamba,
    "rwkv": rwk.init_rwkv_tmix,
}


def _init_blocks(col: ParamCollector, cfg, pattern, L: int,
                 cross: bool = False):
    for i, (mixer, ffn) in enumerate(pattern):
        b = col.sub(f"blk{i}")
        b.param("ln1", (L, cfg.d_model), init="ones")
        _MIXER_INIT[mixer](b.sub("mixer"), cfg, L)
        if cross:
            b.param("ln_x", (L, cfg.d_model), init="ones")
            attn.init_cross(b.sub("cross"), cfg, L)
        if ffn != "none":
            b.param("ln2", (L, cfg.d_model), init="ones")
            f = b.sub("ffn")
            if ffn == "dense":
                init_ffn(f, cfg, L)
            elif ffn == "moe":
                moe_mod.init_moe(f, cfg, L)
            elif ffn == "cmix":
                rwk.init_rwkv_cmix(f, cfg, L)


def _apply_block(bp, x, aux, mixer, ffn, positions, rules, cfg, enc=None):
    h = rms_norm(x, bp["ln1"])
    mp = bp["mixer"]
    if mixer == "global":
        a = attn.apply_gqa(mp, h, positions, rules, cfg, window=None)
    elif mixer == "local":
        a = attn.apply_gqa(mp, h, positions, rules, cfg, window=cfg.window)
    elif mixer == "bidir":
        a = attn.apply_bidir(mp, h, positions, rules, cfg)
    elif mixer == "mla":
        a = attn.apply_mla(mp, h, positions, rules, cfg)
    elif mixer == "mamba":
        a = mam.apply_mamba(mp, h, rules, cfg)
    elif mixer == "rwkv":
        a = rwk.apply_rwkv_tmix(mp, h, rules, cfg)
    else:
        raise KeyError(mixer)
    x = x + a
    if enc is not None:
        hx = rms_norm(x, bp["ln_x"])
        x = x + attn.apply_cross(bp["cross"], hx, enc, rules, cfg)
    if ffn != "none":
        h2 = rms_norm(x, bp["ln2"])
        if ffn == "dense":
            x = x + apply_ffn(bp["ffn"], h2, rules, cfg)
        elif ffn == "moe":
            if cfg.moe_impl == "a2a" and rules is not None:
                raise NotImplementedError(_A2A)
            y, al = moe_mod.apply_moe(bp["ffn"], h2, rules, cfg)
            x = x + y
            aux = aux + al
        elif ffn == "cmix":
            x = x + rwk.apply_rwkv_cmix(bp["ffn"], h2, rules, cfg)
    return x, aux


def _register(module: nn.Module, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = nn.Module()
            module.add_module(k, sub)
            _register(sub, v)
        else:
            module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _tree(module: nn.Module) -> dict:
    out = dict(module.named_parameters(recurse=False))
    out.update((k, _tree(m)) for k, m in module.named_children())
    return out


# ---------------------------------------------------------------- model
class LM(nn.Module):
    """The language model of one ``ArchConfig``: parameters registered
    under the reference's tree paths, its entry points over them."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self._cached = None   # (the parameter tree, each group's views)

    # ---------------------------------------------------------- params
    def init(self, generator: torch.Generator | int | None = None,
             device=None) -> dict:
        """Draw the parameters on ``device`` (None: the card) from
        ``generator`` (a torch.Generator, or a seed; None: seed 0) and
        register them. Returns the parameter tree."""
        dev = resolve_device(device)
        if not isinstance(generator, torch.Generator):
            gdev = dev if dev.type == "cuda" else "cpu"
            generator = torch.Generator(device=gdev).manual_seed(
                int(generator or 0))
        cfg = self.cfg
        col = ParamCollector(generator, dev)
        d, V = cfg.d_model, cfg.vocab_padded
        # d^-0.5 init and x sqrt(d) input scaling (gemma-style)
        col.param("embed", (V, d), scale=d ** -0.5)
        if cfg.n_enc_layers:
            _init_blocks(col.sub("enc_groups"), cfg, (("bidir", "dense"),),
                         cfg.n_enc_layers)
            col.param("enc_ln", (d,), init="ones")
            _init_blocks(col.sub("groups"), cfg, cfg.pattern, cfg.n_groups,
                         cross=True)
        else:
            _init_blocks(col.sub("groups"), cfg, cfg.pattern, cfg.n_groups)
            if cfg.n_tail:
                _init_blocks(col.sub("tail"), cfg,
                             cfg.pattern[: cfg.n_tail], 1)
        col.param("final_ln", (d,), init="ones")
        if not cfg.tie_embeddings:
            col.param("unembed", (d, V))
        self.load_tree(col.params)
        return self.params()

    def load_tree(self, tree: dict) -> None:
        """Register a parameter tree (nested dicts of tensors, the
        reference's paths and shapes), replacing any registered before."""
        for name in [n for n, _ in self.named_children()]:
            delattr(self, name)
        for name in [n for n, _ in self.named_parameters(recurse=False)]:
            delattr(self, name)
        _register(self, tree)
        self._cached = None

    def params(self) -> dict:
        """The registered parameters as the reference's nested dict."""
        return self._views()[0]

    def param_specs(self, axes, rules: Rules):
        raise NotImplementedError(
            "the partition specs of a dry run are not ported yet (ROADMAP "
            "Queue 1 item 15e)")

    def _apply(self, *args, **kwargs):
        self._cached = None   # .to() / .cuda() move the parameters' data
        return super()._apply(*args, **kwargs)

    def _views(self):
        if self._cached is None:
            tree = _tree(self)
            groups = [index_tree(tree["groups"], g)
                      for g in range(self.cfg.n_groups)]
            self._cached = (tree, groups)
        return self._cached

    @property
    def device(self) -> torch.device:
        return self.params()["embed"].device

    # ------------------------------------------------------- forward
    def _embed(self, tokens):
        p = self.params()
        x = p["embed"][tokens]
        return (x * scalar(self.cfg.d_model ** 0.5, x)).to(torch.bfloat16)

    def _embed_inputs(self, batch, rules):
        cfg = self.cfg
        x = self._embed(batch["tokens"])
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(x.dtype),
                           x[:, cfg.frontend_len:]], dim=1)
        return constrain(x, ("batch", "seq", "embed"), rules)

    def forward(self, batch: dict, rules: Rules | None = None):
        """Full causal forward -> (hidden [B,S,d], aux_loss)."""
        cfg = self.cfg
        if cfg.n_enc_layers:
            return self._forward_encdec(batch, rules)
        tree, groups = self._views()
        x = self._embed_inputs(batch, rules)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gp in groups:
            x, aux = self._group_body(x, aux, gp, positions, rules)
        if cfg.n_tail:
            tp = index_tree(tree["tail"], 0)
            for i, (mixer, ffn) in enumerate(cfg.pattern[: cfg.n_tail]):
                x, aux = _apply_block(tp[f"blk{i}"], x, aux, mixer, ffn,
                                      positions, rules, cfg)
        return rms_norm(x, tree["final_ln"]), aux

    def _group_body(self, x, aux, gp, positions, rules, enc=None):
        for i, (mixer, ffn) in enumerate(self.cfg.pattern):
            x, aux = _apply_block(gp[f"blk{i}"], x, aux, mixer, ffn,
                                  positions, rules, self.cfg, enc=enc)
        return x, aux

    def _encode(self, frame_embeds, rules):
        """(encoder hidden before its norm, aux)."""
        tree = self.params()
        x = constrain(frame_embeds.to(torch.bfloat16),
                      ("batch", "seq", "embed"), rules)
        B, Se, _ = x.shape
        epos = torch.arange(Se, device=x.device).expand(B, Se)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(self.cfg.n_enc_layers):
            gp = index_tree(tree["enc_groups"], g)
            x, aux = _apply_block(gp["blk0"], x, aux, "bidir", "dense", epos,
                                  rules, self.cfg)
        return x, aux

    def _forward_encdec(self, batch, rules):
        tree, groups = self._views()
        enc_x, aux = self._encode(batch["frame_embeds"], rules)
        enc_out = rms_norm(enc_x, tree["enc_ln"])
        x = constrain(self._embed(batch["tokens"]),
                      ("batch", "seq", "embed"), rules)
        B, S, _ = x.shape
        dpos = torch.arange(S, device=x.device).expand(B, S)
        for gp in groups:
            x, aux = self._group_body(x, aux, gp, dpos, rules, enc=enc_out)
        return rms_norm(x, tree["final_ln"]), aux

    # ---------------------------------------------------------- loss
    def logits(self, hidden, rules: Rules | None = None):
        """hidden [B, S, d] -> f32 logits [B, S, V] (bf16 operands, f32
        products and sums)."""
        p = self.params()
        w = p["embed"].T if self.cfg.tie_embeddings else p["unembed"]
        return torch.matmul(f32(hidden), f32(w))

    def loss(self, batch: dict, rules: Rules | None = None):
        hidden, aux = self.forward(batch, rules)
        lg = self.logits(hidden, rules)
        labels = batch["labels"]
        mask = (labels >= 0).to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels.clamp(min=0).to(torch.int64)
                            [..., None])[..., 0]
        ce = torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                          min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # --------------------------------------------------------- decode
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Decode cache on the model's device (local attn = ring buffer)."""
        cfg = self.cfg
        dev = self.device
        g = {}
        for i, (mixer, ffn) in enumerate(cfg.pattern):
            c = self._block_cache(mixer, batch, max_len, cfg.n_groups, dev)
            if ffn == "cmix":
                c["x_cm"] = torch.zeros((cfg.n_groups, batch, 1, cfg.d_model),
                                        dtype=torch.bfloat16, device=dev)
            g[f"blk{i}"] = c
        cache = {"groups": g}
        if cfg.n_tail:
            cache["tail"] = {
                f"blk{i}": self._block_cache(mixer, batch, max_len, 1, dev)
                for i, (mixer, ffn) in enumerate(cfg.pattern[: cfg.n_tail])}
        if cfg.n_enc_layers:  # cross-attention K/V, filled at prefill
            shape = (cfg.n_groups, batch, min(max_len, 4096), cfg.n_kv,
                     cfg.hd)
            cache["cross"] = {
                "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
        return cache

    def _block_cache(self, mixer, batch, max_len, stack, dev):
        cfg = self.cfg
        if mixer in ("global", "bidir"):
            return attn.init_gqa_cache(cfg, batch, max_len, stack, dev)
        if mixer == "local":
            W = min(cfg.window, max_len)
            c = attn.init_gqa_cache(cfg, batch, W, stack, dev)
            c["kpos"] = torch.full((stack, batch, W), -1, dtype=torch.int32,
                                   device=dev)
            return c
        if mixer == "mla":
            return attn.init_mla_cache(cfg, batch, max_len, stack, dev)
        if mixer == "mamba":
            return mam.init_mamba_state(cfg, batch, stack, dev)
        if mixer == "rwkv":
            return rwk.init_rwkv_state(cfg, batch, stack, dev)
        raise KeyError(mixer)

    def _decode_block(self, bp, bc, x, pos, mixer, ffn, rules,
                      cross_kv=None):
        cfg = self.cfg
        h = rms_norm(x, bp["ln1"])
        mp = bp["mixer"]
        if mixer in ("global", "bidir"):
            a, _ = attn.decode_gqa(mp, h, bc, pos, rules, cfg)
        elif mixer == "local":
            a = self._decode_local(mp, h, bc, pos, rules)
        elif mixer == "mla":
            a, _ = attn.decode_mla(mp, h, bc, pos, rules, cfg)
        elif mixer == "mamba":
            a, _ = mam.decode_mamba(mp, h, bc, rules, cfg)
        elif mixer == "rwkv":
            a, S_new = rwk.decode_rwkv_tmix(mp, h, bc["S"], bc["x_tm"],
                                            rules, cfg)
            bc["S"].copy_(S_new)
            bc["x_tm"].copy_(h)
        else:
            raise KeyError(mixer)
        x = x + a
        if cross_kv is not None:
            hx = rms_norm(x, bp["ln_x"])
            x = x + self._decode_cross(bp["cross"], hx, cross_kv, rules)
        if ffn != "none":
            h2 = rms_norm(x, bp["ln2"])
            if ffn == "dense":
                x = x + apply_ffn(bp["ffn"], h2, rules, cfg)
            elif ffn == "moe":
                y, _ = moe_mod.apply_moe(bp["ffn"], h2, rules, cfg)
                x = x + y
            elif ffn == "cmix":
                y = rwk.apply_rwkv_cmix(bp["ffn"], h2, rules, cfg,
                                        x_last=bc["x_cm"])
                bc["x_cm"].copy_(h2)
                x = x + y
        return x

    def _decode_local(self, mp, h, bc, pos, rules):
        """Ring-buffer sliding-window decode: slot = pos % window."""
        cfg = self.cfg
        B = h.shape[0]
        W = bc["k"].shape[1]
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=h.device)
        q, k1, v1 = attn._qkv(mp, h, positions, cfg)
        slot = pos % W
        bc["k"][:, slot] = k1[:, 0].to(bc["k"].dtype)
        bc["v"][:, slot] = v1[:, 0].to(bc["v"].dtype)
        bc["kpos"][:, slot] = pos
        kpos = bc["kpos"]
        valid = (kpos <= pos) & (kpos > pos - cfg.window) & (kpos >= 0)
        o = attn.attend_cache(q[:, 0], bc["k"], bc["v"], valid, h.dtype)
        return dense(o, mp["wo"])

    def _decode_cross(self, cp, hx, cross_kv, rules):
        cfg = self.cfg
        B = hx.shape[0]
        H, K, dh = cfg.n_heads, cfg.n_kv, cfg.hd
        q = dense(hx, cp["wq"]).reshape(B, K, H // K, dh)
        s = einsum32("bkgd,bskd->bkgs", q, cross_kv["k"]) / (dh ** 0.5)
        w = softmax(s)
        o = torch.einsum("bkgs,bskd->bkgd", w, f32(cross_kv["v"]))
        return dense(o.to(hx.dtype).reshape(B, 1, H * dh), cp["wo"])

    def decode_step(self, cache: dict, token, pos: int,
                    rules: Rules | None = None, enc_out=None):
        """One-token decode at position ``pos`` -> (logits f32 [B, V],
        cache, updated in place)."""
        cfg = self.cfg
        tree, groups = self._views()
        x = constrain(self._embed(token[:, None]),
                      ("batch", None, "embed"), rules)
        for g, gp in enumerate(groups):
            gc = index_tree(cache["groups"], g)
            cross = (index_tree(cache["cross"], g) if cfg.n_enc_layers
                     else None)
            for i, (mixer, ffn) in enumerate(cfg.pattern):
                x = self._decode_block(gp[f"blk{i}"], gc[f"blk{i}"], x, pos,
                                       mixer, ffn, rules, cross_kv=cross)
        if cfg.n_tail:
            tp = index_tree(tree["tail"], 0)
            tc = index_tree(cache["tail"], 0)
            for i, (mixer, ffn) in enumerate(cfg.pattern[: cfg.n_tail]):
                x = self._decode_block(tp[f"blk{i}"], tc[f"blk{i}"], x, pos,
                                       mixer, ffn, rules)
        x = rms_norm(x, tree["final_ln"])
        return self.logits(x, rules)[:, 0], cache

    # ----------------------------------------------------- serve utils
    def prefill_logits(self, batch: dict, rules: Rules | None = None):
        """Forward pass -> last-position logits [B, V]."""
        hidden, _ = self.forward(batch, rules)
        return self.logits(hidden[:, -1:], rules)[:, 0]

    def prefill_via_decode(self, cache: dict, tokens,
                           rules: Rules | None = None, enc_out=None):
        """Token-by-token prefill -> (last logits [B, V], cache)."""
        lg = None
        for i in range(tokens.shape[1]):
            lg, cache = self.decode_step(cache, tokens[:, i], i, rules,
                                         enc_out=enc_out)
        return lg, cache

    def encode(self, frame_embeds, rules: Rules | None = None):
        """Encoder stack -> enc_out [B, Se, d] (seamless)."""
        x, _ = self._encode(frame_embeds, rules)
        return rms_norm(x, self.params()["enc_ln"])

    def build_cross_cache(self, enc_out) -> dict:
        """Decoder cross K/V from the encoder output (stacked [G])."""
        cfg = self.cfg
        B, Se, _ = enc_out.shape
        cp = self.params()["groups"]["blk0"]["cross"]
        k = einsum32("bsd,gdk->gbsk", enc_out, cp["wk"]).to(torch.bfloat16)
        v = einsum32("bsd,gdk->gbsk", enc_out, cp["wv"]).to(torch.bfloat16)
        shape = (cfg.n_groups, B, Se, cfg.n_kv, cfg.hd)
        return {"k": k.reshape(shape), "v": v.reshape(shape)}
