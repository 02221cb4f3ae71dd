"""Mixture-of-Experts FFN: top-k routing, capacity dispatch (the reference's
GSPMD path; the all-to-all island is ROADMAP Queue 1 item 15b).

Dispatch uses sort-based ranking into fixed [E, C, d] buffers and a batched
expert product of E * C * d * ff, as the reference does. Routing follows the
reference's choices: the router in f32, ``lax.top_k``'s order (the lower
expert first on ties, ``serve.engine._top_k``), a stable argsort, the
``searchsorted`` ranking and the capacity formula. Overflowed tokens land
in slot C, which collects duplicate writes and is then dropped. Shared
experts run dense alongside.
"""
from __future__ import annotations

import dataclasses

import torch

from ..serve.engine import _top_k
from .common import (ACTIVATIONS, ParamCollector, constrain, dense, einsum32,
                     f32, softmax)


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 1
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


def init_moe(col: ParamCollector, cfg, layer_stack: int) -> None:
    d = cfg.d_model
    m: MoECfg = cfg.moe
    L = layer_stack
    col.param("router", (L, d, m.num_experts), dtype=torch.float32)
    col.param("wi_gate", (L, m.num_experts, d, m.d_ff_expert))
    col.param("wi_up", (L, m.num_experts, d, m.d_ff_expert))
    col.param("wo_e", (L, m.num_experts, m.d_ff_expert, d))
    if m.shared_experts:
        ff = m.d_ff_expert * m.shared_experts
        col.param("ws_gate", (L, d, ff))
        col.param("ws_up", (L, d, ff))
        col.param("ws_down", (L, ff, d))


def route(p, xt: torch.Tensor, cfg):
    """The router over tokens xt [T, d]: (probs f32[T, E], renormalized
    top_p f32[T, k], top_e int64[T, k])."""
    m: MoECfg = cfg.moe
    logits = torch.matmul(f32(xt), p["router"])
    probs = softmax(logits)
    top_p, top_e = _top_k(probs, m.top_k)
    return probs, top_p / torch.sum(top_p, -1, keepdim=True), top_e


def apply_moe(p, x, rules, cfg):
    """x [B, S, d] -> (y [B, S, d], aux_loss)."""
    B, S, d = x.shape
    m: MoECfg = cfg.moe
    E = m.num_experts
    act = ACTIVATIONS[cfg.act]
    T = B * S
    dev = x.device
    xt = x.reshape(T, d)
    probs, top_p, top_e = route(p, xt, cfg)
    # load-balance aux loss (Switch-style)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(top_e[:, 0], E)
                    .to(torch.float32), dim=0)
    aux = m.router_aux_weight * m.num_experts * torch.sum(me * ce)

    # ---- sort-based position-in-expert ranking
    flat_e = top_e.reshape(-1)                               # [T*k]
    Tk = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first_of = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank_sorted = torch.arange(Tk, device=dev) - first_of[sorted_e]
    pos = torch.zeros(Tk, dtype=torch.int64, device=dev)
    pos[order] = rank_sorted
    # capacity: at small T (decode) an expert can receive at most T tokens
    C = int(max(-(-T * m.top_k // m.num_experts) * m.capacity_factor,
                min(T, 256)))
    keep = pos < C
    pos_c = torch.where(keep, pos, C)                        # C = overflow

    # ---- dispatch: [E, C+1, d] buffers (slot C collects dropped tokens)
    tok_idx = torch.arange(T, device=dev).repeat_interleave(m.top_k)
    buf = torch.zeros((E, C + 1, d), dtype=x.dtype, device=dev)
    buf[flat_e, pos_c] = xt[tok_idx]
    buf = buf[:, :C]

    # ---- expert FFN (flop-exact grouped compute)
    h = act(einsum32("ecd,edf->ecf", buf, p["wi_gate"]).to(x.dtype))
    u = einsum32("ecd,edf->ecf", buf, p["wi_up"]).to(x.dtype)
    eo = einsum32("ecf,efd->ecd", h * u, p["wo_e"]).to(x.dtype)

    # ---- combine: gather back, weight by router prob, drop overflow
    eo_pad = torch.cat([eo, torch.zeros((E, 1, d), dtype=eo.dtype,
                                        device=dev)], 1)
    out_flat = eo_pad[flat_e, pos_c]                         # [T*k, d]
    w = (top_p.reshape(-1) * keep).to(x.dtype)
    y = torch.sum((out_flat * w[:, None]).reshape(T, m.top_k, d), dim=1)

    if m.shared_experts:
        hs = act(dense(xt, p["ws_gate"])) * dense(xt, p["ws_up"])
        y = y + dense(hs, p["ws_down"])
    y = y.reshape(B, S, d)
    return constrain(y, ("batch", "seq", "embed"), rules), aux
