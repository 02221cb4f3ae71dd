"""The Cheetah switch-pruning engine in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``repro``. Public surface, the reference's and
``StreamResult`` / ``lane_view``:

    from repro_torch import (engine_prune, engine_prune_batch,
                             engine_prune_stream, run_query, run_queries,
                             QuerySpec, Table, ExecOptions, PlanCache,
                             PruneStream)

``ExecOptions`` is the one bundle of execution knobs both entry points
accept as ``options=``. ``repro_torch.obs`` is the telemetry layer: results
carry an ``ExecReport`` (``result.report``) unless ``obs="off"``, counters
aggregate in ``repro_torch.obs.REGISTRY`` and ``obs="trace"`` records spans
for Chrome-trace export. ``PruneStream`` folds micro-batches through S
resident lane states and ``close()`` equals one-shot two_pass on the
lane-view stream (``lane_view``).

Entry points run on the device their tensors live on; constructors put
tensors on the card unless given ``device="cpu"``.
"""
from . import obs  # noqa: E402
from .core.batch_engine import engine_prune_batch  # noqa: E402
from .core.engine import engine_prune  # noqa: E402
from .core.options import ExecOptions  # noqa: E402
from .core.plancache import PlanCache  # noqa: E402
from .core.streaming import (PruneStream, StreamResult,  # noqa: E402
                             engine_prune_stream, lane_view)
from .obs import ExecReport  # noqa: E402
from .query.engine import QuerySpec, run_queries, run_query  # noqa: E402
from .query.tables import (DictColumn, PlainColumn, RLEColumn,  # noqa: E402
                           Table, dict_column, rle_column)

__all__ = ["DictColumn", "ExecOptions", "ExecReport", "PlainColumn",
           "PlanCache", "PruneStream", "QuerySpec", "RLEColumn",
           "StreamResult", "Table", "dict_column", "engine_prune",
           "engine_prune_batch", "engine_prune_stream", "lane_view", "obs",
           "rle_column", "run_queries", "run_query"]
