"""seamless-m4t-large-v2 [audio]: enc-dec 24L+24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206 [arXiv:2308.11596; hf]. Audio frontend is a STUB:
input_specs provides precomputed frame embeddings for the encoder."""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv=16, d_ff=8192, vocab=256206, head_dim=64, act="gelu",
    ffn_glu=False, rope_theta=1e4, pattern=(("global", "dense"),),
    n_enc_layers=24, frontend="audio", full_attention=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=512, head_dim=16)
