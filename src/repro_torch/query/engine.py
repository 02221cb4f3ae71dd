"""Query execution on one device: switch pruning, then master completion.

Without a mesh every query runs ``core.engine_prune`` in ``scan`` mode (one
switch lane over the table), and the master completes the query on the
survivors. Ported: TOP-N with ``mode="rand"`` (the default) and DISTINCT
with ``policy="fifo"``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import core
from ..core.hashing import as_u32
from .tables import Table

_QUEUED = ("join", "having", "skyline", "groupby", "filter")


@dataclasses.dataclass
class QuerySpec:
    kind: str          # distinct|topn|join|having|skyline|groupby|filter
    columns: tuple     # relevant column names
    params: dict       # algorithm params (d, w, N, policy, seed, ...)


def _engine_call(algo: str, streams: tuple, params: dict) -> core.PruneResult:
    """One engine invocation per query: the sequential scan (no mesh)."""
    return core.engine_prune(algo, *streams, mode="scan", **params)


def _prepare(spec: QuerySpec, table: Table):
    """(algo, streams, engine params, completion) for one query."""
    k = spec.kind
    p = dict(spec.params)
    if k == "distinct":
        (cname,) = spec.columns
        stream = table.col(cname).values
        params = dict(d=p["d"], w=p["w"], policy=p.get("policy", "lru"))
        if "seed" in p:
            params["seed"] = p["seed"]

        def complete(r):
            out_mask = core.master_complete_distinct(stream, r.keep)
            uniq = torch.unique(as_u32(stream)[out_mask])
            return _result(uniq.to(torch.int32).view(torch.uint32), r.keep)

        return "distinct", (stream,), params, complete
    if k == "topn":
        (cname,) = spec.columns
        stream = table.col(cname).values
        if p.get("mode", "rand") != "rand":
            raise NotImplementedError(
                "TOP-N mode='det' (the threshold ladder) is not ported yet "
                "(ROADMAP Queue 1 item 3: the topn_det scan kernel)")
        params = dict(d=p["d"], w=p["w"])
        if "seed" in p:
            params["seed"] = p["seed"]

        def complete(r):
            topv, topi = core.master_complete_topn(stream, r.keep, p["N"])
            return _result((topv, topi), r.keep)

        return "topn_rand", (stream,), params, complete
    if k in _QUEUED:
        raise NotImplementedError(
            f"query kind {k!r} is not ported yet (ROADMAP Queue 1 item 5)")
    raise KeyError(k)


def run_query(spec: QuerySpec, tables, mesh=None, axis: str = "data",
              tune: str | None = None, plan_cache=None, options=None,
              decode: str | None = None, obs: str | None = None) -> dict:
    """Execute a query with switch pruning; returns output + statistics.

    Runs on the device the table's columns live on. ``output`` is
    ``(values, indices)`` of the top N for TOP-N and the sorted distinct
    values for DISTINCT.
    """
    del axis
    if mesh is not None:
        raise NotImplementedError(
            "run_query(mesh=) is not ported yet (ROADMAP Queue 1 item 7)")
    if tune not in (None, "off") or plan_cache is not None:
        raise NotImplementedError(
            "run_query(tune=) is not ported yet (ROADMAP Queue 1 item 11)")
    if options is not None:
        raise NotImplementedError(
            "run_query(options=) is not ported yet (ROADMAP Queue 1 item 6)")
    if decode is not None:
        raise NotImplementedError(
            "run_query(decode=) is not ported yet (ROADMAP Queue 1 item 10)")
    if obs not in (None, "off"):
        raise NotImplementedError(
            "run_query(obs=) is not ported yet (ROADMAP Queue 1 item 12)")
    algo, streams, params, complete = _prepare(spec, tables)
    r = _engine_call(algo, streams, params)
    return complete(r)


def _result(output, keep: torch.Tensor) -> dict:
    keepf = keep.to(torch.float32)
    return {
        "output": output,
        "keep": keep,
        "forwarded": int(keepf.sum()),
        "total": int(keepf.shape[0]),
        "pruned_fraction": float(1 - keepf.mean()),
        "report": None,
    }
