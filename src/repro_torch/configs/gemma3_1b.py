"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
5:1 local:global [hf:google/gemma-3-1b-pt; unverified]. 26 = 4 groups + 2 tail."""
import dataclasses

from .base import ArchConfig

_PAT = (("local", "dense"),) * 5 + (("global", "dense"),)

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense", n_layers=26, d_model=1152, n_heads=4,
    n_kv=1, d_ff=6912, vocab=262144, head_dim=256, act="gelu", ffn_glu=True,
    qk_norm=True, rope_theta=1e6, pattern=_PAT, window=512,
    tie_embeddings=True, full_attention=False,
    notes="long_500k runnable: only 1/6 layers hold full-length KV",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv=1, d_ff=128,
        vocab=512, head_dim=16, window=8)
