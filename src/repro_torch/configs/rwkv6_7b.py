"""rwkv6-7b [ssm]: 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536
RWKV-6 Finch: data-dependent decay linear recurrence [arXiv:2404.05892; hf].
Constant-size state => long_500k decodes with O(1) memory."""
import dataclasses

from ..models.rwkv import RWKVCfg

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, n_heads=64,
    n_kv=64, d_ff=14336, vocab=65536, head_dim=64, act="silu",
    pattern=(("rwkv", "cmix"),), rwkv=RWKVCfg(head_dim=64, decay_lora=64),
    full_attention=False,
    notes="attention-free; Cheetah pruning applies on data/grad/logit paths",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=512, head_dim=16, rwkv=RWKVCfg(head_dim=16, decay_lora=8))
