"""The Cheetah switch-pruning engine in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``repro``, slice by slice. Public surface so far:

    from repro_torch import (engine_prune, run_query, QuerySpec, Table,
                             ExecOptions)

``ExecOptions`` is the one bundle of execution knobs both entry points
accept as ``options=``. ``repro_torch.obs`` is the telemetry layer: results
carry an ``ExecReport`` (``result.report``) unless ``obs="off"``, counters
aggregate in ``repro_torch.obs.REGISTRY`` and ``obs="trace"`` records spans
for Chrome-trace export.

Entry points run on the device their tensors live on; constructors put
tensors on the card unless given ``device="cpu"``.
"""
from . import obs  # noqa: E402
from .core.engine import engine_prune  # noqa: E402
from .core.options import ExecOptions  # noqa: E402
from .obs import ExecReport  # noqa: E402
from .query.engine import QuerySpec, run_query  # noqa: E402
from .query.tables import (DictColumn, PlainColumn, RLEColumn,  # noqa: E402
                           Table, dict_column, rle_column)

__all__ = ["DictColumn", "ExecOptions", "ExecReport", "PlainColumn",
           "QuerySpec", "RLEColumn", "Table", "dict_column", "engine_prune",
           "obs", "rle_column", "run_query"]
