"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MLA + MoE 256e top-8 + 1 shared [arXiv:2412.19437; hf].
Simplifications vs HF config (noted in DESIGN.md): all layers MoE (V3 has
3 leading dense layers); MTP head omitted."""
import dataclasses

from ..models.moe import MoECfg

from .base import ArchConfig, MLACfg

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv=128, d_ff=2048, vocab=129280, head_dim=128, act="silu",
    ffn_glu=True, rope_theta=1e4, pattern=(("mla", "moe"),),
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, qk_nope=128, qk_rope=64,
               v_dim=128),
    moe=MoECfg(num_experts=256, top_k=8, d_ff_expert=2048, shared_experts=1),
    full_attention=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=64,
        vocab=512, head_dim=16,
        mla=MLACfg(q_lora_rank=32, kv_lora_rank=16, qk_nope=16, qk_rope=8,
                   v_dim=16),
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=64, shared_experts=1))
