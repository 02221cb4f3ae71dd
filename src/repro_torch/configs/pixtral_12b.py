"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
pixtral-ViT + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409; unverified].
Modality frontend is a STUB: input_specs provides precomputed patch embeddings."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120, n_heads=32,
    n_kv=8, d_ff=14336, vocab=131072, head_dim=128, act="silu", ffn_glu=True,
    rope_theta=1e6, pattern=(("global", "dense"),), frontend="vision",
    frontend_len=256, full_attention=True,
    notes="vision tower stubbed; text backbone = mistral-nemo-style GQA",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16, frontend_len=4)
