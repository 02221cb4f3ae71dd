"""Attention family: GQA/MQA (full, causal, sliding-window) and MLA.

All variants share the reference's contract, over dicts of tensors:
  init_*(col, cfg, L)                       -> params in the collector
  apply_*(p, x, positions, rules, cfg, ...) -> y            (train/prefill)
  decode_*(p, x1, cache, pos, rules, cfg)   -> y1, cache    (one token)

Sliding-window attention is computed chunked (queries attend to their own
and the previous chunk), as the reference does. Decode writes the new
token's keys and values into the cache in place and reads the whole cache
through an f32 partial softmax.
"""
from __future__ import annotations

import torch

from .common import (ParamCollector, constrain, dense, einsum32, f32, rms_norm,
                     rotary, softmax)

NEG_INF = -2.3e38


# ------------------------------------------------------------------ GQA
def init_gqa(col: ParamCollector, cfg, layer_stack: int) -> None:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    L = layer_stack
    col.param("wq", (L, d, H * dh))
    col.param("wk", (L, d, K * dh))
    col.param("wv", (L, d, K * dh))
    col.param("wo", (L, H * dh, d))
    if cfg.qk_norm:
        col.param("q_norm", (L, dh), init="ones")
        col.param("k_norm", (L, dh), init="ones")


def _qkv(p, x, positions, cfg):
    B, S, d = x.shape
    H, K, dh = cfg.n_heads, cfg.n_kv, cfg.hd
    q = dense(x, p["wq"]).reshape(B, S, H, dh)
    k = dense(x, p["wk"]).reshape(B, S, K, dh)
    v = dense(x, p["wv"]).reshape(B, S, K, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, rules):
    """q [B,Sq,H,dh], k/v [B,Sk,K,dh] -> [B,Sq,H,dv]; GQA head grouping.
    mask: "causal" | "full"."""
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, dh)
    scores = einsum32("bqkgd,bskd->bkgqs", qg, k) / (dh ** 0.5)
    if mask == "causal":
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    w = softmax(scores).to(q.dtype)
    o = einsum32("bkgqs,bskd->bqkgd", w, v).to(q.dtype)
    o = o.reshape(B, Sq, H, v.shape[-1])  # v head dim may differ (MLA)
    return constrain(o, ("batch", "seq", "heads", None), rules)


def apply_gqa(p, x, positions, rules, cfg, window: int | None = None):
    """Causal attention; window != None -> chunked sliding-window."""
    B, S, d = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    if window is None or window >= S:
        o = _sdpa(q, k, v, "causal", rules)
    else:
        o = _windowed(q, k, v, window)
    y = dense(o.reshape(B, S, -1), p["wo"])
    return constrain(y, ("batch", "seq", "embed"), rules)


def _windowed(q, k, v, W):
    """Chunked local attention: chunk C=W; attend to own + previous chunk."""
    B, S0, H, dh = q.shape
    K = k.shape[2]
    C = min(W, S0)
    pad = (-S0) % C
    if pad:  # padding keys sit in the causal future of every real query
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
    S = S0 + pad
    nc = S // C
    qc = q.reshape(B, nc, C, H, dh)
    kc = k.reshape(B, nc, C, K, dh)
    vc = v.reshape(B, nc, C, K, dh)
    prev_k = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    prev_v = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1]
    kk = torch.cat([prev_k, kc], dim=2)  # [B, nc, 2C, K, dh]
    vv = torch.cat([prev_v, vc], dim=2)
    G = H // K
    qg = qc.reshape(B, nc, C, K, G, dh)
    scores = einsum32("bnqkgd,bnskd->bnkgqs", qg, kk) / (dh ** 0.5)
    dev = q.device
    qpos = torch.arange(C, device=dev)[:, None] + C   # within [prev|own]
    kpos = torch.arange(2 * C, device=dev)[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - W)
    first = torch.arange(nc, device=dev)[:, None, None] > 0
    ok = ok[None] & (first | (kpos[None] >= C))       # [nc, C, 2C]
    scores = torch.where(ok[:, None, None], scores, NEG_INF)
    w = softmax(scores).to(q.dtype)
    o = einsum32("bnkgqs,bnskd->bnqkgd", w, vv).to(q.dtype)
    return o.reshape(B, S, H, dh)[:, :S0]


def init_gqa_cache(cfg, batch: int, max_len: int, layer_stack: int, device,
                   dtype=torch.bfloat16) -> dict:
    shape = (layer_stack, batch, max_len, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attend_cache(q, ck, cv, valid, dtype):
    """One query token against a K/V cache: q [B,H,dh], ck/cv [B,Smax,K,dh],
    valid bool [Smax] or [B, Smax] -> [B, 1, H*dh] in ``dtype``; the
    reference's f32 partial softmax (max, exp, sums, one divide)."""
    B, H, dh = q.shape
    K = ck.shape[2]
    qg = q.reshape(B, K, H // K, dh)
    # "bkgd,bskd->bkgs" and "bkgs,bskd->bkgd" as batched products: one
    # decode step runs two a layer, and torch.einsum's path search costs
    # more host time than the product
    s = torch.matmul(f32(qg), f32(ck).permute(0, 2, 3, 1)) / (dh ** 0.5)
    valid = valid[:, None, None] if valid.dim() == 2 else valid
    s = torch.where(valid, s, NEG_INF)
    mx = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    num = torch.matmul(e, f32(cv).permute(0, 2, 1, 3))
    den = torch.sum(e, dim=-1, keepdim=True)
    return (num / den).to(dtype).reshape(B, 1, H * dh)


def decode_gqa(p, x1, cache, pos: int, rules, cfg, window: int | None = None):
    """One-token decode. x1 [B,1,d]; cache k/v [B,Smax,K,dh] (written in
    place at ``pos``); pos an int."""
    B = x1.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x1.device)
    q, k1, v1 = _qkv(p, x1, positions, cfg)
    ck, cv = cache["k"], cache["v"]
    ck[:, pos] = k1[:, 0].to(ck.dtype)
    cv[:, pos] = v1[:, 0].to(cv.dtype)
    kpos = torch.arange(ck.shape[1], device=x1.device)
    valid = kpos <= pos
    if window is not None:
        valid &= kpos > pos - window
    o = attend_cache(q[:, 0], ck, cv, valid, x1.dtype)
    return dense(o, p["wo"]), cache


# ------------------------------------------------------------------ MLA
def init_mla(col: ParamCollector, cfg, layer_stack: int) -> None:
    d, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    L = layer_stack
    col.param("wq_a", (L, d, m.q_lora_rank))
    col.param("q_a_norm", (L, m.q_lora_rank), init="ones")
    col.param("wq_b", (L, m.q_lora_rank, H * (m.qk_nope + m.qk_rope)))
    col.param("wkv_a", (L, d, m.kv_lora_rank + m.qk_rope))
    col.param("kv_a_norm", (L, m.kv_lora_rank), init="ones")
    col.param("wk_b", (L, m.kv_lora_rank, H * m.qk_nope))
    col.param("wv_b", (L, m.kv_lora_rank, H * m.v_dim))
    col.param("wo", (L, H * m.v_dim, d))


def apply_mla(p, x, positions, rules, cfg, window=None):
    """Train/prefill MLA (materialized K/V per head)."""
    B, S, d = x.shape
    H, m = cfg.n_heads, cfg.mla
    q = dense(rms_norm(dense(x, p["wq_a"]), p["q_a_norm"]), p["wq_b"])
    q = q.reshape(B, S, H, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    kv = dense(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., :m.kv_lora_rank], p["kv_a_norm"])
    k_rope = rotary(kv[..., None, m.kv_lora_rank:], positions, cfg.rope_theta)
    q_rope = rotary(q_rope, positions, cfg.rope_theta)
    k_nope = dense(c_kv, p["wk_b"]).reshape(B, S, H, m.qk_nope)
    v = dense(c_kv, p["wv_b"]).reshape(B, S, H, m.v_dim)
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope)], -1)
    o = _sdpa(qf, kf, v, "causal", rules)
    y = dense(o.reshape(B, S, -1), p["wo"])
    return constrain(y, ("batch", "seq", "embed"), rules)


def init_mla_cache(cfg, batch: int, max_len: int, layer_stack: int, device,
                   dtype=torch.bfloat16) -> dict:
    m = cfg.mla
    return {"c_kv": torch.zeros((layer_stack, batch, max_len,
                                 m.kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((layer_stack, batch, max_len, m.qk_rope),
                                  dtype=dtype, device=device)}


def decode_mla(p, x1, cache, pos: int, rules, cfg, window=None):
    """Matrix-absorbed MLA decode: attention in the latent space."""
    B = x1.shape[0]
    H, m = cfg.n_heads, cfg.mla
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x1.device)
    q = dense(rms_norm(dense(x1, p["wq_a"]), p["q_a_norm"]), p["wq_b"])
    q = q.reshape(B, H, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = rotary(q_rope[:, None], positions, cfg.rope_theta)[:, 0]
    kv = dense(x1, p["wkv_a"])[:, 0]
    c_new = rms_norm(kv[:, :m.kv_lora_rank], p["kv_a_norm"])
    kr_new = rotary(kv[:, None, None, m.kv_lora_rank:], positions,
                    cfg.rope_theta)[:, 0, 0]
    ck, kr = cache["c_kv"], cache["k_rope"]
    ck[:, pos] = c_new.to(ck.dtype)
    kr[:, pos] = kr_new.to(kr.dtype)
    # absorb W_UK into q: q_lat [B,H,kv_rank]
    wkb = p["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope)
    q_lat = einsum32("bhn,rhn->bhr", q_nope, wkb).to(x1.dtype)
    s = (einsum32("bhr,bsr->bhs", q_lat, ck)
         + einsum32("bhn,bsn->bhs", q_rope, kr)
         ) / ((m.qk_nope + m.qk_rope) ** 0.5)
    valid = torch.arange(ck.shape[1], device=x1.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    mx = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    o_lat = torch.einsum("bhs,bsr->bhr", e, f32(ck))
    o_lat = (o_lat / torch.sum(e, -1, keepdim=True)).to(x1.dtype)
    wvb = p["wv_b"].reshape(m.kv_lora_rank, H, m.v_dim)
    o = einsum32("bhr,rhv->bhv", o_lat, wvb).to(x1.dtype)
    return dense(o.reshape(B, 1, H * m.v_dim), p["wo"]), cache


# ------------------------------------------------- encoder / cross attn
def apply_bidir(p, x, positions, rules, cfg):
    """Encoder self-attention (no causal mask)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, positions, cfg)
    o = _sdpa(q, k, v, "full", rules)
    return constrain(dense(o.reshape(B, S, -1), p["wo"]),
                     ("batch", "seq", "embed"), rules)


def init_cross(col: ParamCollector, cfg, layer_stack: int) -> None:
    d, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    L = layer_stack
    col.param("wq", (L, d, H * dh))
    col.param("wk", (L, d, K * dh))
    col.param("wv", (L, d, K * dh))
    col.param("wo", (L, H * dh, d))


def apply_cross(p, x, enc, rules, cfg):
    """Decoder cross-attention over encoder outputs [B, Senc, d]."""
    B, S, _ = x.shape
    Senc = enc.shape[1]
    H, K, dh = cfg.n_heads, cfg.n_kv, cfg.hd
    q = dense(x, p["wq"]).reshape(B, S, H, dh)
    k = dense(enc, p["wk"]).reshape(B, Senc, K, dh)
    v = dense(enc, p["wv"]).reshape(B, Senc, K, dh)
    o = _sdpa(q, k, v, "full", rules)
    return constrain(dense(o.reshape(B, S, -1), p["wo"]),
                     ("batch", "seq", "embed"), rules)
