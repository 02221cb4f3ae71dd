"""The Cheetah switch-pruning engine in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``repro``, slice by slice. Public surface so far:

    from repro_torch import engine_prune, run_query, QuerySpec, Table

Entry points run on the device their tensors live on; constructors put
tensors on the card unless given ``device="cpu"``.
"""
from .core.engine import engine_prune  # noqa: E402
from .query.engine import QuerySpec, run_query  # noqa: E402
from .query.tables import (DictColumn, PlainColumn, RLEColumn,  # noqa: E402
                           Table, dict_column, rle_column)

__all__ = ["DictColumn", "PlainColumn", "QuerySpec", "RLEColumn", "Table",
           "dict_column", "engine_prune", "rle_column", "run_query"]
