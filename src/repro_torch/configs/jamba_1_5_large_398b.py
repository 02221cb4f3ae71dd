"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, Mamba+attn 1:7 interleave, MoE 16e top-2 every other layer
[arXiv:2403.19887; hf]. Pattern period 8 (attn at position 4), 9 groups."""
import dataclasses

from ..models.mamba import MambaCfg
from ..models.moe import MoECfg

from .base import ArchConfig

_PAT = (("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("global", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe"))

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv=8, d_ff=24576, vocab=65536, head_dim=128, act="silu",
    ffn_glu=True, rope_theta=1e4, pattern=_PAT,
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=24576, shared_experts=0),
    full_attention=False,
    notes="long_500k runnable: only 1/8 layers hold full-length KV",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16, mamba=MambaCfg(d_state=4, d_conv=4, expand=2),
        moe=MoECfg(num_experts=4, top_k=2, d_ff_expert=128, shared_experts=0))
