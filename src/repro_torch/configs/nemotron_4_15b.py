"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU, no GLU [arXiv:2402.16819; unverified]."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv=8, d_ff=24576, vocab=256000, head_dim=128, act="relu2",
    ffn_glu=False, rope_theta=1e4, pattern=(("global", "dense"),),
    full_attention=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16)
