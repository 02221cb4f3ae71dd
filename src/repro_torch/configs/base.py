"""Architecture config schema + the shape grid (assigned cells).

Each assigned architecture is a frozen ArchConfig; `smoke()` derives a
reduced same-family config for CPU tests; `input_specs()` builds
allocation-free stand-ins (tensors on the "meta" device) for every
(arch × shape) dry-run cell.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models.mamba import MambaCfg
from ..models.moe import MoECfg
from ..models.rwkv import RWKVCfg


@dataclasses.dataclass(frozen=True)
class MLACfg:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


# pattern entries: (mixer, ffn)
#   mixer ∈ {global, local, mla, mamba, rwkv, bidir}
#   ffn   ∈ {dense, moe, cmix, none}
@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    act: str = "silu"
    ffn_glu: bool = True
    qk_norm: bool = False
    rope_theta: float = 1e4
    pattern: tuple = (("global", "dense"),)
    window: int = 1024           # sliding window for "local" mixers
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    rwkv: Optional[RWKVCfg] = None
    mla: Optional[MLACfg] = None
    n_enc_layers: int = 0        # encoder-decoder only
    frontend: Optional[str] = None   # vision|audio stub
    frontend_len: int = 256      # patches / frames prepended
    tie_embeddings: bool = False
    full_attention: bool = True  # False → long_500k cell is runnable
    moe_impl: str = "gspmd"      # gspmd (baseline) | a2a (§Perf shard_map)
    moe_int8_dispatch: bool = False  # §Perf B4: int8 a2a payloads
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256  # 128-lane × 2 sharding-friendly

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_padded
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        per_mixer = {}
        dh, H, K = self.hd, self.n_heads, self.n_kv
        per_mixer["global"] = per_mixer["local"] = per_mixer["bidir"] = \
            d * H * dh + 2 * d * K * dh + H * dh * d
        if self.mla:
            m = self.mla
            per_mixer["mla"] = (d * m.q_lora_rank + m.q_lora_rank * H * (m.qk_nope + m.qk_rope)
                                + d * (m.kv_lora_rank + m.qk_rope)
                                + m.kv_lora_rank * H * (m.qk_nope + m.v_dim)
                                + H * m.v_dim * d)
        if self.mamba:
            di = self.mamba.expand * d
            dtr = -(-d // 16)
            per_mixer["mamba"] = (d * 2 * di + self.mamba.d_conv * di
                                  + di * (dtr + 2 * self.mamba.d_state)
                                  + dtr * di + di * self.mamba.d_state + di * d)
        if self.rwkv:
            per_mixer["rwkv"] = 4 * d * d + d * self.rwkv.decay_lora * 2 + d * d
        per_ffn = {"dense": (3 if self.ffn_glu else 2) * d * ff,
                   "cmix": d * ff * 2 + d * d, "none": 0}
        if self.moe:
            m = self.moe
            per_ffn["moe"] = (d * m.num_experts + 3 * m.num_experts * d * m.d_ff_expert
                              + 3 * d * m.d_ff_expert * m.shared_experts)
        total_layers = list(self.pattern) * self.n_groups \
            + list(self.pattern)[: self.n_tail]
        for mixer, ffn in total_layers:
            n += per_mixer[mixer] + per_ffn[ffn]
        if self.n_enc_layers:
            # encoder layers: bidir attn + dense ffn; decoder adds cross attn
            n += self.n_enc_layers * (per_mixer["bidir"] + per_ffn["dense"])
            n += self.n_layers * per_mixer["global"]  # cross-attn per dec layer
        return n

    def active_param_count(self) -> int:
        """Active (per-token) params for MoE rooflines: 6·N_active·D."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        full_moe_ffn = 3 * m.num_experts * d_ffe(m) * self.d_model
        active_moe_ffn = 3 * m.top_k * d_ffe(m) * self.d_model
        moe_layers = sum(1 for _, f in (list(self.pattern) * self.n_groups
                                        + list(self.pattern)[:self.n_tail]) if f == "moe")
        return self.param_count() - moe_layers * (full_moe_ffn - active_moe_ffn)


def d_ffe(m: MoECfg) -> int:
    return m.d_ff_expert


# ------------------------------------------------------------ the grid
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def cell_runnable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """Whether an (arch × shape) cell runs; reason when skipped."""
    if shape == "long_500k" and cfg.full_attention:
        return False, "pure full-attention arch: 500k KV cache is quadratic-" \
                      "history; skipped per DESIGN.md §Arch-applicability"
    return True, ""


def input_specs(cfg: ArchConfig, shape: str) -> dict:
    """Allocation-free stand-ins for every model input of a shape cell:
    tensors on the "meta" device, of the shape and dtype each input has."""
    s = SHAPES[shape]
    B, S = s["batch"], s["seq"]
    i32 = torch.int32

    def sd(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if s["kind"] == "train":
        out = {"tokens": sd((B, S), i32), "labels": sd((B, S), i32)}
        if cfg.frontend == "vision":
            out["patch_embeds"] = sd((B, cfg.frontend_len, cfg.d_model),
                                     torch.bfloat16)
        if cfg.frontend == "audio":
            out["frame_embeds"] = sd((B, S, cfg.d_model), torch.bfloat16)
        return out
    if s["kind"] == "prefill":
        out = {"tokens": sd((B, S), i32)}
        if cfg.frontend == "vision":
            out["patch_embeds"] = sd((B, cfg.frontend_len, cfg.d_model),
                                     torch.bfloat16)
        if cfg.frontend == "audio":
            out["frame_embeds"] = sd((B, S, cfg.d_model), torch.bfloat16)
        return out
    # decode: one token with a seq_len KV cache (built by the launcher)
    out = {"token": sd((B,), i32), "pos": sd((), i32)}
    if cfg.frontend == "audio":
        out["enc_out"] = sd((B, min(S, 4096), cfg.d_model), torch.bfloat16)
    return out
