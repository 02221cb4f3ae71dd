"""RWKV-6 (Finch) time-mix + channel-mix: chunked linear recurrence.

Per head (dh channels): S_t = diag(w_t) S_{t-1} + k_t v_t^T ;
o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T), with data-dependent decay w_t
(token-shift + low-rank head). Within a chunk of 16 the decay ratios are
applied through log-space cumulative sums, the reference's formula
(r * e^{lprev}, k * e^{-lcum}, f32); a Python loop over chunks carries the
state [H, dh, dh], where the reference has a ``lax.scan``. Decode carries
(S, last-token shift).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import ParamCollector, constrain, dense, f32, sigmoid, silu


@dataclasses.dataclass(frozen=True)
class RWKVCfg:
    head_dim: int = 64
    decay_lora: int = 64


def init_rwkv_tmix(col: ParamCollector, cfg, layer_stack: int) -> None:
    d = cfg.d_model
    L = layer_stack
    rc: RWKVCfg = cfg.rwkv
    for n in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
        col.param(n, (L, d), init="ones")
    col.param("wr", (L, d, d))
    col.param("wk", (L, d, d))
    col.param("wv", (L, d, d))
    col.param("wg", (L, d, d))
    col.param("w_lora_a", (L, d, rc.decay_lora))
    col.param("w_lora_b", (L, rc.decay_lora, d))
    col.param("w_base", (L, d), init="zeros", dtype=torch.float32)
    col.param("u_bonus", (L, d), init="ones", dtype=torch.float32)
    col.param("ln_out", (L, d), init="ones")
    col.param("wo", (L, d, d))


def _tshift(x, last=None):
    """Token shift: x_{t-1} (zeros / carried last token at t=0)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _heads(x, H, dh):
    B, S, _ = x.shape
    return x.reshape(B, S, H, dh)


def _mix(p, m, x, xprev):
    return x * p[m][None, None] + xprev * (1 - p[m][None, None])


def _rkvwg(p, x, xprev, cfg):
    d = cfg.d_model
    H = d // cfg.rwkv.head_dim
    dh = cfg.rwkv.head_dim
    r = _heads(dense(_mix(p, "mix_r", x, xprev), p["wr"]), H, dh)
    k = _heads(dense(_mix(p, "mix_k", x, xprev), p["wk"]), H, dh)
    v = _heads(dense(_mix(p, "mix_v", x, xprev), p["wv"]), H, dh)
    g = silu(dense(_mix(p, "mix_g", x, xprev), p["wg"]))
    wl = dense(torch.tanh(dense(_mix(p, "mix_w", x, xprev), p["w_lora_a"])),
               p["w_lora_b"])
    logw = -torch.exp(f32(p["w_base"][None, None]) + f32(wl))  # < 0
    # the reference's clamp: 16 steps x 5 = 80 < log(f32 max) ~ 88.7
    logw = torch.clamp(logw, -5.0, -1e-5)
    logw = _heads(logw, H, dh)
    u = f32(p["u_bonus"].reshape(H, dh))
    return f32(r), f32(k), f32(v), g, logw, u


def _wkv_chunked(r, k, v, logw, u, S0, chunk: int = 16):
    """r,k,v,logw [B,S,H,dh]; u [H,dh]; S0 [B,H,dh,dh] -> o, S_T. fp32."""
    B, S, H, dh = r.shape
    L = min(chunk, S)
    nc = S // L

    def chunks(t):
        # [nc, B, H, L, dh]
        return t.reshape(B, nc, L, H, dh).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = (chunks(t) for t in (r, k, v, logw))
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    Sst = S0
    os_ = []
    for c in range(nc):
        rl, kl, vl, wl = rc[c], kc[c], vc[c], wc[c]        # [B,H,L,dh]
        lcum = torch.cumsum(wl, dim=2)                     # logD_t (inclusive)
        lprev = lcum - wl                                  # logD_{t-1}
        r_in = rl * torch.exp(lprev)
        k_in = kl * torch.exp(-lcum)
        # intra-chunk (strictly lower triangular) + bonus diagonal
        att = torch.einsum("bhld,bhmd->bhlm", r_in, k_in)
        att = torch.where(tril[None, None], att, 0.0)
        bonus = torch.einsum("bhld,hd,bhld->bhl", rl, u, kl)
        o = (torch.einsum("bhlm,bhmd->bhld", att, vl)
             + torch.einsum("bhld,bhde->bhle", r_in, Sst)
             + bonus[..., None] * vl)
        # state to end of chunk
        dec_rest = torch.exp(lcum[:, :, -1:] - lcum)
        Sst = (Sst * torch.exp(lcum[:, :, -1])[..., None]
               + torch.einsum("bhld,bhle->bhde", kl * dec_rest, vl))
        os_.append(o)
    o = torch.stack(os_).permute(1, 0, 3, 2, 4).reshape(B, S, H, dh)
    return o, Sst


def _groupnorm(o, gamma, H, dh, eps=1e-5):
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, unbiased=False)
    o = (o - mu) * torch.rsqrt(var + eps)
    return o.reshape(*o.shape[:-2], H * dh) * gamma


def apply_rwkv_tmix(p, x, rules, cfg, chunk: int = 16):
    B, S, d = x.shape
    H, dh = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    r, k, v, g, logw, u = _rkvwg(p, x, _tshift(x), cfg)
    S0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
    o, _ = _wkv_chunked(r, k, v, logw, u, S0, chunk)
    o = _groupnorm(o, p["ln_out"][None, None], H, dh).to(x.dtype)
    y = dense(o * g, p["wo"])
    return constrain(y, ("batch", "seq", "embed"), rules)


def init_rwkv_state(cfg, batch: int, layer_stack: int, device) -> dict:
    d = cfg.d_model
    H, dh = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    return {"S": torch.zeros((layer_stack, batch, H, dh, dh),
                             dtype=torch.float32, device=device),
            "x_tm": torch.zeros((layer_stack, batch, 1, d),
                                dtype=torch.bfloat16, device=device)}


def decode_rwkv_tmix(p, x1, state_S, x_last, rules, cfg):
    """One-token time-mix: (y, the new state S)."""
    d = cfg.d_model
    H, dh = d // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    r, k, v, g, logw, u = _rkvwg(p, x1, _tshift(x1, x_last), cfg)
    r1, k1, v1, w1 = r[:, 0], k[:, 0], v[:, 0], torch.exp(logw[:, 0])
    o = (torch.einsum("bhd,bhde->bhe", r1, state_S)
         + torch.einsum("bhd,hd,bhd,bhe->bhe", r1, u, k1, v1))
    S_new = state_S * w1[..., None] + torch.einsum("bhd,bhe->bhde", k1, v1)
    o = _groupnorm(o, p["ln_out"][None], H, dh).to(x1.dtype)
    y = dense((o * g[:, 0])[:, None], p["wo"])
    return y, S_new


# --------------------------------------------------------- channel mix
def init_rwkv_cmix(col: ParamCollector, cfg, layer_stack: int) -> None:
    d, ff = cfg.d_model, cfg.d_ff
    L = layer_stack
    col.param("mix_k", (L, d), init="ones")
    col.param("mix_r", (L, d), init="ones")
    col.param("wk_c", (L, d, ff))
    col.param("wv_c", (L, ff, d))
    col.param("wr_c", (L, d, d))


def apply_rwkv_cmix(p, x, rules, cfg, x_last=None):
    xprev = _tshift(x, x_last)
    kk = torch.square(F.relu(dense(_mix(p, "mix_k", x, xprev), p["wk_c"])))
    rr = sigmoid(dense(_mix(p, "mix_r", x, xprev), p["wr_c"]))
    return constrain(rr * dense(kk, p["wv_c"]), ("batch", "seq", "embed"),
                     rules)
