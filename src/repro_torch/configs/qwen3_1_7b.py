"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048, n_heads=16,
    n_kv=8, d_ff=6144, vocab=151936, head_dim=128, act="silu", ffn_glu=True,
    qk_norm=True, rope_theta=1e6, pattern=(("global", "dense"),),
    full_attention=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16)
