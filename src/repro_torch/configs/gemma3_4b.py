"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144
5:1 local:global interleave, 128k context [hf:google/gemma-3-1b-pt; unverified].
34 = 5 full pattern groups + 4 tail (local) layers."""
import dataclasses

from .base import ArchConfig

_PAT = (("local", "dense"),) * 5 + (("global", "dense"),)

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560, n_heads=8,
    n_kv=4, d_ff=10240, vocab=262144, head_dim=256, act="gelu", ffn_glu=True,
    qk_norm=True, rope_theta=1e6, pattern=_PAT, window=1024,
    tie_embeddings=True, full_attention=False,
    notes="long_500k runnable: only 1/6 layers hold full-length KV",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv=2, d_ff=128,
        vocab=512, head_dim=16, window=8)
