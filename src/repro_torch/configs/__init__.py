"""The ten architecture configs and their reduced smoke variants.

The same configs as the JAX package's ``repro.configs``; see each module's
source tag. `get(name)` returns the full ArchConfig, `get_smoke(name)` a
reduced same-family config for CPU tests.
"""
from .base import ArchConfig, SHAPES, input_specs, cell_runnable
from . import (pixtral_12b, nemotron_4_15b, gemma3_4b, gemma3_1b, qwen3_1_7b,
               rwkv6_7b, moonshot_v1_16b_a3b, deepseek_v3_671b,
               jamba_1_5_large_398b, seamless_m4t_large_v2)

_MODULES = {
    "pixtral-12b": pixtral_12b,
    "nemotron-4-15b": nemotron_4_15b,
    "gemma3-4b": gemma3_4b,
    "gemma3-1b": gemma3_1b,
    "qwen3-1.7b": qwen3_1_7b,
    "rwkv6-7b": rwkv6_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
}

ARCH_NAMES = list(_MODULES)


def get(name: str) -> ArchConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _MODULES[name].smoke()
