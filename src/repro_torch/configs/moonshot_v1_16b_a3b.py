"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 (+2 shared, deepseek-style)
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
import dataclasses

from ..models.moe import MoECfg

from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=163840, head_dim=128, act="silu",
    ffn_glu=True, rope_theta=5e4, pattern=(("global", "moe"),),
    moe=MoECfg(num_experts=64, top_k=6, d_ff_expert=1408, shared_experts=2),
    full_attention=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=64,
        vocab=512, head_dim=16,
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=64, shared_experts=1))
