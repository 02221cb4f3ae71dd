"""Mamba (S6) layer for the Jamba hybrid: chunked selective scan.

The per-(channel, state) recurrence h <- exp(delta A) h + delta B x is a
1-D linear recurrence. Within a chunk of 64 steps it runs as the
reference's ``lax.associative_scan`` runs it (the same pairing tree,
``associative_scan`` below), and a Python loop over chunks carries h
[B, d_inner, N], where the reference has a ``lax.scan``. Decode keeps
(h, conv window) as constant-size state.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import ParamCollector, constrain, dense, f32, silu


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


def init_mamba(col: ParamCollector, cfg, layer_stack: int) -> None:
    d = cfg.d_model
    mc: MambaCfg = cfg.mamba
    di = mc.expand * d
    dtr = mc.dt_rank or -(-d // 16)
    L = layer_stack
    col.param("in_proj", (L, d, 2 * di))
    col.param("conv_w", (L, mc.d_conv, di), scale=0.5)
    col.param("x_proj", (L, di, dtr + 2 * mc.d_state))
    col.param("dt_proj", (L, dtr, di), scale=dtr ** -0.5)
    col.param("dt_bias", (L, di), init="zeros", dtype=torch.float32)
    col.param("A_log", (L, di, mc.d_state), init="ones", dtype=torch.float32)
    col.param("D", (L, di), init="ones", dtype=torch.float32)
    col.param("out_proj", (L, di, d))


def associative_scan(fn, elems: tuple, dim: int) -> tuple:
    """``jax.lax.associative_scan(fn, elems, axis=dim)``: the same tree of
    pairings (adjacent pairs combined, the odd positions scanned
    recursively, the even ones completed from them), so every element is
    combined in the reference's order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(sl(o, 0, -1) for o in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        shape = list(ev.shape)
        shape[dim] = n
        t = ev.new_empty(shape)
        sl(t, 0, None, 2).copy_(ev)
        sl(t, 1, None, 2).copy_(od)
        out.append(t)
    return tuple(out)


def _comb(x, y):
    return (x[0] * y[0], y[0] * x[1] + y[1])


def _ssm_chunked(u, delta, Bt, Ct, A, D, h0, chunk: int, rules):
    """u,delta [B,S,di]; Bt,Ct [B,S,N]; A [di,N]; h0 [B,di,N] -> y, hT."""
    Bsz, S, di = u.shape
    N = A.shape[-1]
    L = min(chunk, S)
    nc = S // L
    uc = u.reshape(Bsz, nc, L, di)
    dc = delta.reshape(Bsz, nc, L, di)
    Bc = Bt.reshape(Bsz, nc, L, N)
    Cc = Ct.reshape(Bsz, nc, L, N)
    h = h0
    ys = []
    for c in range(nc):
        ucl, dcl, Bcl, Ccl = uc[:, c], dc[:, c], Bc[:, c], Cc[:, c]
        aa = torch.exp(dcl[..., None] * A[None, None])      # [B, L, di, N]
        bb = (dcl * ucl)[..., None] * Bcl[:, :, None, :]    # [B, L, di, N]
        # prepend the carry as an extra step: h' = a*h_prev + b
        aa0 = torch.cat([torch.ones((Bsz, 1, di, N), dtype=aa.dtype,
                                    device=aa.device), aa], 1)
        bb0 = torch.cat([h[:, None], bb], 1)
        _, hs = associative_scan(_comb, (aa0, bb0), 1)
        hs = hs[:, 1:]                                      # [B, L, di, N]
        y = torch.einsum("blin,bln->bli", hs, Ccl)
        h = hs[:, -1]
        ys.append(y.to(u.dtype))
    y = torch.stack(ys, 1).reshape(Bsz, S, di)
    return y + u * D[None, None], h


def _pre_ssm(p, x, cfg):
    """Shared in-proj + SSM sizes."""
    mc: MambaCfg = cfg.mamba
    di = mc.expand * cfg.d_model
    dtr = mc.dt_rank or -(-cfg.d_model // 16)
    xz = dense(x, p["in_proj"])
    u, z = xz[..., :di], xz[..., di:]
    return u, z, di, dtr


def _conv(u, w, state=None):
    """Depthwise causal conv along seq; state = last (k-1) inputs or None."""
    k = w.shape[0]
    if state is None:
        pad = F.pad(u, (0, 0, k - 1, 0))
    else:
        pad = torch.cat([state.to(u.dtype), u], dim=1)
    out = sum(pad[:, i:i + u.shape[1]] * w[i][None, None] for i in range(k))
    return silu(out), pad[:, -(k - 1):]


def _heads_ssm(p, u, cfg, dtr):
    """(delta f32, B f32, C f32) from the conv output u."""
    mc: MambaCfg = cfg.mamba
    xdbc = dense(u, p["x_proj"])
    dt = f32(dense(xdbc[..., :dtr], p["dt_proj"])) + p["dt_bias"][None, None]
    delta = torch.logaddexp(dt, torch.zeros_like(dt))  # jax.nn.softplus
    return (delta, f32(xdbc[..., dtr:dtr + mc.d_state]),
            f32(xdbc[..., dtr + mc.d_state:]))


def apply_mamba(p, x, rules, cfg, chunk: int = 64):
    mc: MambaCfg = cfg.mamba
    B, S, d = x.shape
    u, z, di, dtr = _pre_ssm(p, x, cfg)
    u, _ = _conv(u, p["conv_w"])
    delta, Bt, Ct = _heads_ssm(p, u, cfg, dtr)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((B, di, mc.d_state), dtype=torch.float32,
                     device=x.device)
    y, _ = _ssm_chunked(f32(u), delta, Bt, Ct, A, p["D"], h0, chunk, rules)
    y = y.to(x.dtype) * silu(z)
    out = dense(y, p["out_proj"])
    return constrain(out, ("batch", "seq", "embed"), rules)


def init_mamba_state(cfg, batch: int, layer_stack: int, device) -> dict:
    mc: MambaCfg = cfg.mamba
    di = mc.expand * cfg.d_model
    return {"h": torch.zeros((layer_stack, batch, di, mc.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((layer_stack, batch, mc.d_conv - 1, di),
                                dtype=torch.bfloat16, device=device)}


def decode_mamba(p, x1, state, rules, cfg):
    """One-token decode: x1 [B,1,d]; state {h, conv}, updated in place."""
    u, z, di, dtr = _pre_ssm(p, x1, cfg)
    u, conv_state = _conv(u, p["conv_w"], state["conv"])
    delta, Bt, Ct = _heads_ssm(p, u, cfg, dtr)
    delta, Bt, Ct = delta[:, 0], Bt[:, 0], Ct[:, 0]
    A = -torch.exp(p["A_log"])
    a = torch.exp(delta[..., None] * A[None])
    u0 = f32(u[:, 0])
    h = a * state["h"] + (delta * u0)[..., None] * Bt[:, None]
    y = torch.einsum("bin,bn->bi", h, Ct) + u0 * p["D"][None]
    y = (y.to(x1.dtype) * silu(z[:, 0]))[:, None]
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return dense(y, p["out_proj"]), state
