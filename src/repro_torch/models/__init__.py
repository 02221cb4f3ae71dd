"""LM substrate: attention/MoE/Mamba/RWKV blocks and the pattern-grouped
stack."""
from .common import Rules, make_rules, tree_specs
from .transformer import LM

__all__ = ["LM", "Rules", "make_rules", "tree_specs"]
