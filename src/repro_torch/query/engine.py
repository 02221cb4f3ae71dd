"""Query execution on one device: switch pruning, then master completion.

Without a mesh every single-table pruner runs ``core.engine_prune`` in
``scan`` mode (one switch lane over the table), and the master completes the
query on the survivors. JOIN keeps its own two-table Bloom exchange and
FILTER is stateless. Ported: TOP-N with ``mode="rand"`` (the default),
DISTINCT with ``policy="fifo"``, SKYLINE, HAVING, GROUP BY, JOIN and FILTER.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .. import core
from ..core.hashing import as_u32
from .tables import Table


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
    if k == "having":
        kname, vname = spec.columns
        kcol, vcol = table.col(kname), table.col(vname)
        agg = p.get("agg", "sum")
        params = dict(threshold=p["threshold"], rows=p.get("rows", 3),
                      width=p.get("width", 1024), agg=agg)
        if "seed" in p:
            params["seed"] = p["seed"]

        def complete(r):
            # compact first: only survivor values are ever read
            kidx = torch.nonzero(r.keep).flatten()
            out = core.master_complete_having(
                kcol.take(kidx), vcol.take(kidx),
                torch.ones(kidx.shape[0], dtype=torch.bool,
                           device=kidx.device), p["threshold"], agg)
            return _result(out, r.keep)

        return "having", (kcol.values, vcol.values), params, complete
    if k == "skyline":
        # uint32 columns by value (torch promotes no uint32), then the
        # common type, as jnp.stack promotes: f32 as soon as one is f32
        cols = [table.col(c).decoded() for c in spec.columns]
        cols = [as_u32(c) if c.dtype == torch.uint32 else c for c in cols]
        dtype = functools.reduce(torch.promote_types,
                                 [c.dtype for c in cols])
        pts = torch.stack([c.to(dtype) for c in cols], dim=-1)
        params = dict(w=p["w"], score=p.get("score", "aph"))

        def complete(r):
            return _result(core.master_complete_skyline(pts, r.keep), r.keep)

        return "skyline", (pts,), params, complete
    if k == "groupby":
        kname, vname = spec.columns
        agg = p.get("agg", "sum")
        params = dict(d=p["d"], w=p["w"], agg=agg)
        if "seed" in p:
            params["seed"] = p["seed"]

        def complete(r):
            out = core.master_complete_groupby(r, agg)
            # switch->master traffic = valid evictions + valid state slots;
            # the JAX package reports ~traffic as the keep mask (ROADMAP
            # Queue 3), and so does the port
            traffic = torch.cat([r.emitted[2].reshape(-1),
                                 r.state.valid.reshape(-1)])
            return _result(out, ~traffic)

        return ("groupby", (table.col(kname).values, table.col(vname).values),
                params, complete)
    raise KeyError(k)


def _run_join(spec: QuerySpec, tables, p: dict) -> dict:
    """Two-table Bloom exchange on one worker: F_A (seed 0) over A's keys
    and F_B (seed 7919) over B's, each table pruned by the other's filter,
    then the master's exact join of the survivors."""
    ta, tb = tables
    ka_name, kb_name = spec.columns
    ka, kb = ta.col(ka_name).decoded(), tb.col(kb_name).decoded()
    nbits, H = p["nbits"], p.get("num_hashes", 3)
    fa = core.bloom_build(ka, nbits, H, seed=0)
    fb = core.bloom_build(kb, nbits, H, seed=7919)
    keep_a, keep_b = core.bloom_query(fb, ka), core.bloom_query(fa, kb)
    va = ta.col(p.get("payload_a", ka_name)).decoded()
    vb = tb.col(p.get("payload_b", kb_name)).decoded()
    out = core.master_complete_join(ka, va, keep_a, kb, vb, keep_b)
    return _result(out, torch.cat([keep_a, keep_b]))


def _run_filter(spec: QuerySpec, table: Table, p: dict) -> dict:
    formula = p["formula"]
    cols = {c: table.col(c).decoded() for c in spec.columns}
    pr = core.filter_prune(formula, cols, p.get("truthtable", True))
    final = core.master_complete_filter(formula, cols, pr.keep)
    return _result(torch.nonzero(final).flatten(), pr.keep)


def run_query(spec: QuerySpec, tables, mesh=None, axis: str = "data",
              tune: str | None = None, plan_cache=None, options=None,
              decode: str | None = None, obs: str | None = None) -> dict:
    """Execute a query with switch pruning; returns output + statistics.

    Runs on the device the table's columns live on. ``output`` is
    ``(values, indices)`` of the top N for TOP-N, the sorted distinct
    values for DISTINCT, the bool skyline membership mask over the rows for
    SKYLINE, the sorted list of qualifying keys for HAVING, the dict
    {key: aggregate} for GROUP BY, the three aligned tensors (key, val_a,
    val_b) of the sorted matches for JOIN (``tables`` is the pair (A, B);
    keep covers A's rows, then B's), and the int64 indices of the matching
    rows for FILTER.
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
    if spec.kind == "join":
        return _run_join(spec, tables, dict(spec.params))
    if spec.kind == "filter":
        return _run_filter(spec, tables, dict(spec.params))
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
