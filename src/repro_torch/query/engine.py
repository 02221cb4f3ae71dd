"""Query execution: workers, switch pruning, then master completion.

Without a mesh every single-table pruner runs ``core.engine_prune`` in
``scan`` mode (one switch lane over the table), or with ``tune="cached"`` /
``"race"`` a plan of the self-tuning planner through ``core.execute_plan``
(two_pass; the answer is the same), and the master completes the query on
the survivors. With a mesh (``core.mesh.Mesh``, axis ``"data"``: the worker
rack), each position is a worker with one switch lane: ``engine_prune``
runs ``mode="mesh"`` with ``pass2="mesh"`` (the lane states gathered
across the workers, the merged state applied to each worker's resident
rows), and only the keep mask is flattened for the master
(``core.unshard_mask``). JOIN keeps its own two-table Bloom exchange (with
a mesh each worker builds its filters, which are ORed over the mesh: the
shared switch filter) and FILTER is stateless; both ignore ``tune``.
Ported: TOP-N with ``mode="rand"`` (the default) or ``"det"``, DISTINCT
with ``policy="lru"`` (the default) or ``"fifo"``, SKYLINE, HAVING, GROUP
BY, JOIN and FILTER, on plain, dictionary- and RLE-encoded columns.

Encoded columns (``DictColumn`` / ``RLEColumn``) prune in code space, and
the completions decode pass-1 survivors only (``Column.take``):
- DISTINCT dedups codes (the sorted dictionary is a bijection) and decodes
  the survivors;
- TOP-N sorts codes (code order is value order, and equal values share a
  code, so the index tie-break holds) and decodes the N winners. The codes
  are compared in f32, as the JAX package compares them, which is exact
  below 2^24 codes only (ROADMAP Queue 3);
- HAVING groups survivor codes, aggregates decoded survivor values and
  decodes only the qualifying keys;
- SKYLINE compares codes only when every column shares one dictionary
  (order isomorphism per dimension keeps dominance), else decoded values;
- GROUP BY is unchanged: the engine decodes inside the scan, so its state
  already holds decoded keys.
``decode="eager"`` decodes every column up front instead.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import core
from ..constants import NEG
from ..core.options import ExecOptions
from ..core.encoding import ambiguous_floats, take_rows
from ..core.hashing import as_u32, by_value
from ..kernels.ops import first_value
from .tables import DictColumn, Table


@dataclasses.dataclass
class QuerySpec:
    kind: str          # distinct|topn|join|having|skyline|groupby|filter
    columns: tuple     # relevant column names
    params: dict       # algorithm params (d, w, N, policy, seed, ...)


def _num_workers(mesh, axis: str = "data") -> int:
    return 1 if mesh is None else mesh.shape[axis]


def _check_tune(tune: str, mesh) -> None:
    if tune not in core.TUNE_MODES:
        raise ValueError(
            f"tune must be one of {core.TUNE_MODES}, got {tune!r}")
    if tune != "off" and mesh is not None:
        raise ValueError(
            "tune= picks its own lane count and device spread; it can't "
            "be combined with an explicit worker mesh (the mesh IS the "
            "deployment) — pass mesh=None or tune='off'")


def _code_stream(col, decode: str):
    """(engine stream, encoding) of one column under the decode policy."""
    if decode == "eager":
        return col.decoded(), None
    return col.code_stream()


def _unique_values(x: torch.Tensor) -> torch.Tensor:
    """The sorted distinct values of ``x``, as ``np.unique`` gives them:
    uint32 by value, and every NaN collapsed into one last entry; where
    np.unique's pick of a zero or a NaN is open (``ambiguous_floats``), its
    own answer on a host copy."""
    if ambiguous_floats(x):
        return torch.from_numpy(np.unique(x.cpu().numpy())).to(x.device)
    if x.dtype == torch.uint32:
        return torch.unique(as_u32(x)).to(torch.int32).view(torch.uint32)
    if x.is_floating_point():
        nan = x.isnan()
        u = torch.unique(x[~nan])
        return torch.cat([u, x[nan][:1]]) if bool(nan.any()) else u
    return torch.unique(x)


def _stack_points(vals: list) -> torch.Tensor:
    """[m, D] points of the columns, in the common type that ``jnp.stack``
    gives with x64 off: f32 as soon as one is a float; uint32 with a signed
    integer is int32, a uint32 of 2^31 or more wrapping negative (int64
    narrowed to int32); uint32 alone by value (torch compares no uint32)."""
    signed = any(not v.is_floating_point() and v.dtype.is_signed
                 for v in vals)
    if signed and any(v.dtype == torch.uint32 for v in vals) and not any(
            v.is_floating_point() for v in vals):
        return torch.stack([v.view(torch.int32) if v.dtype == torch.uint32
                            else v.to(torch.int32) for v in vals], dim=-1)
    vals = [as_u32(v) if v.dtype == torch.uint32 else v for v in vals]
    dtype = functools.reduce(torch.promote_types, [v.dtype for v in vals])
    return torch.stack([v.to(dtype) for v in vals], dim=-1)


def _seeded(params: dict, p: dict) -> dict:
    if "seed" in p:
        params["seed"] = p["seed"]
    return params


def _prepare(spec: QuerySpec, table: Table, decode: str = "auto"):
    """(algo, streams, encodings, engine params, completion) for one
    query; ``complete`` maps the engine's result to the result dict."""
    k = spec.kind
    p = dict(spec.params)
    if k == "distinct":
        (cname,) = spec.columns
        col = table.col(cname)
        stream, enc = _code_stream(col, decode)
        params = _seeded(dict(d=p["d"], w=p["w"],
                              policy=p.get("policy", "lru")), p)

        def complete(r):
            out_mask = core.master_complete_distinct(stream, r.keep)
            idx = torch.nonzero(out_mask).flatten()
            return _result(_unique_values(col.take(idx)), r.keep)

        return "distinct", (stream,), (enc,), params, complete
    if k == "topn":
        (cname,) = spec.columns
        col = table.col(cname)
        stream, enc = _code_stream(col, decode)
        if p.get("mode", "rand") == "rand":
            algo, params = "topn_rand", _seeded(dict(d=p["d"], w=p["w"]), p)
        else:
            algo, params = "topn_det", dict(N=p["N"], w=p.get("w", 4))

        def complete(r):
            topv, topi = core.master_complete_topn(stream, r.keep, p["N"])
            if enc is not None:
                # decode the N winners through their rows; slots without a
                # survivor (fewer than N) stay NEG. The codes are ordered
                # as f32, as the reference orders them: exact below 2^24
                # codes only (ROADMAP Queue 3).
                topv = torch.where(topv != NEG,
                                   col.take(topi).to(torch.float32),
                                   float(NEG))
            return _result((topv, topi), r.keep)

        return algo, (stream,), (enc,), params, complete
    if k == "having":
        kname, vname = spec.columns
        kcol, vcol = table.col(kname), table.col(vname)
        kstream, kenc = _code_stream(kcol, decode)
        vstream, venc = _code_stream(vcol, decode)
        agg = p.get("agg", "sum")
        params = _seeded(dict(threshold=p["threshold"], rows=p.get("rows", 3),
                              width=p.get("width", 1024), agg=agg), p)

        def complete(r):
            # compact first: only survivor values are ever decoded
            kidx = torch.nonzero(r.keep).flatten()
            out = core.master_complete_having(
                take_rows(kstream, kidx), vcol.take(kidx),
                torch.ones(kidx.shape[0], dtype=torch.bool,
                           device=kidx.device), p["threshold"], agg)
            if kenc is not None:  # the sorted order of codes is the keys'
                lut = by_value(kenc.lut)
                out = [lut[c].item() for c in out]
            return _result(out, r.keep)

        return ("having", (kstream, vstream), (kenc, venc), params,
                complete)
    if k == "skyline":
        cols = [table.col(c) for c in spec.columns]
        encs = [c.encoding if isinstance(c, DictColumn) else None
                for c in cols]
        # code-space dominance needs ONE dictionary for all D dimensions
        shared = (decode != "eager" and all(e is not None for e in encs)
                  and all(e is encs[0] for e in encs))
        if shared:
            pts = torch.stack([by_value(c.codes) for c in cols], dim=-1)
            enc = encs[0]
        else:
            pts, enc = _stack_points([c.decoded() for c in cols]), None
        params = dict(w=p["w"], score=p.get("score", "aph"))

        def complete(r):
            # dominance is per-dimension <= / <; a shared sorted dictionary
            # keeps both, so the mask needs no decode
            return _result(core.master_complete_skyline(pts, r.keep), r.keep)

        return "skyline", (pts,), (enc,), params, complete
    if k == "groupby":
        kname, vname = spec.columns
        kstream, kenc = _code_stream(table.col(kname), decode)
        vstream, venc = _code_stream(table.col(vname), decode)
        agg = p.get("agg", "sum")
        params = _seeded(dict(d=p["d"], w=p["w"], agg=agg), p)

        def complete(r):
            # the engine decodes inside the scan: r.state and r.emitted
            # hold decoded keys and values, as in the plain run
            out = core.master_complete_groupby(r, agg)
            # switch->master traffic = valid evictions + valid state slots;
            # the JAX package reports ~traffic as the keep mask (ROADMAP
            # Queue 3), and so does the port
            traffic = torch.cat([r.emitted[2].reshape(-1),
                                 r.state.valid.reshape(-1)])
            return _result(out, ~traffic)

        return ("groupby", (kstream, vstream), (kenc, venc), params,
                complete)
    raise KeyError(k)


def _engine_call(algo: str, streams: tuple, mesh, axis: str, params: dict,
                 tune: str = "off", plan_cache=None, encoding=None,
                 obs: str | None = None) -> core.PruneResult:
    """One engine call a query: with a mesh, S = one lane a worker on the
    data axis and pass 2 resident on the workers, the keep flattened to
    bool[m] (only the mask is gathered); without one the scan, or with
    ``tune`` the cached or raced two-pass plan."""
    if mesh is None:
        return core.engine_prune(algo, *streams, mode="scan", tune=tune,
                                 plan_cache=plan_cache, encoding=encoding,
                                 obs=obs, **params)
    r = core.engine_prune(algo, *streams, mode="mesh",
                          shards=mesh.shape[axis], mesh=mesh, mesh_axis=axis,
                          pass2="mesh", encoding=encoding, obs=obs, **params)
    out = core.PruneResult(
        keep=core.unshard_mask(r.keep, streams[0].shape[0], mesh),
        state=r.state, emitted=r.emitted)
    out.report = r.report  # the telemetry rides along
    return out


def _bloom_merged(parts: list, mesh) -> core.BloomFilter:
    """The workers' filters ORed over the mesh, as the reference's psum of
    their bits as int32, then > 0: the one filter a shared switch holds."""
    from ..kernels.bloom_filter import pack_bits

    f0 = parts[0]
    bits = mesh.all_reduce([f.bits.to(torch.int32) for f in parts]) > 0
    return core.BloomFilter(words=pack_bits(bits), nbits=f0.nbits,
                            num_hashes=f0.num_hashes, seed=f0.seed)


def _run_join(spec: QuerySpec, tables, mesh, axis: str, p: dict) -> dict:
    """Two-table Bloom exchange: F_A (seed 0) over A's keys and F_B (seed
    7919) over B's, each table pruned by the other's filter, then the
    master's exact join of the survivors. With a mesh each worker builds
    both filters over its rows (the tail padded with the first key, already
    a member, so no filter changes), the filters are ORed over the mesh and
    each worker queries its own rows."""
    ta, tb = tables
    ka_name, kb_name = spec.columns
    ka, kb = ta.col(ka_name).decoded(), tb.col(kb_name).decoded()
    nbits, H = p["nbits"], p.get("num_hashes", 3)
    if mesh is None:
        fa = core.bloom_build(ka, nbits, H, seed=0)
        fb = core.bloom_build(kb, nbits, H, seed=7919)
        keep_a, keep_b = core.bloom_query(fb, ka), core.bloom_query(fa, kb)
    else:
        nw = _num_workers(mesh, axis)
        ka_st = core.shard_stack(ka, nw, first_value(ka))
        kb_st = core.shard_stack(kb, nw, first_value(kb))
        pos = mesh.positions(1)
        ka_w = [ka_st[g0].to(dev) for dev, g0 in pos]
        kb_w = [kb_st[g0].to(dev) for dev, g0 in pos]
        FA = _bloom_merged([core.bloom_build(k, nbits, H, seed=0)
                            for k in ka_w], mesh)
        FB = _bloom_merged([core.bloom_build(k, nbits, H, seed=7919)
                            for k in kb_w], mesh)
        home = mesh.devices[0]

        def query(F, ks):
            # each worker's rows against the merged filter, then every
            # worker's mask (O(rows) bools) for the master
            keep = torch.cat([core.bloom_query(dataclasses.replace(
                F, words=F.words.to(k.device)), k).to(home) for k in ks])
            return mesh.all_gather([keep]) if mesh.world > 1 else keep

        keep_a = query(FB, ka_w)[:ka.shape[0]].to(ka.device)
        keep_b = query(FA, kb_w)[:kb.shape[0]].to(kb.device)
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
              tune: str | None = None, plan_cache=None,
              options: ExecOptions | None = None,
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

    ``decode``: ``"auto"`` / ``"late"`` (the default) prune encoded columns
    in code space and decode the survivors only; ``"eager"`` decodes every
    column up front.

    ``mesh`` / ``axis``: a ``core.mesh.Mesh`` whose positions on ``axis``
    are the workers, one switch lane each (``engine_prune(mode="mesh",
    pass2="mesh")``; JOIN's filters ORed over it); the answer is the one
    without a mesh.

    ``tune``: ``"off"`` (the default), ``"cached"`` or ``"race"``: a
    self-tuned two-pass engine plan for the single-table pruners (JOIN and
    FILTER ignore it), ``plan_cache`` its ``PlanCache``; the answer is the
    same at all three. It cannot be combined with ``mesh=``.

    ``options``: an ``ExecOptions`` bundle (tune, plan_cache, decode and
    obs apply here; mode, shards, pass2 and apply_block are the mesh's at
    this layer and are refused). ``obs``: the telemetry level (see
    ``core.engine_prune``); the result's ``"report"`` is the engine's
    ``ExecReport``, None for JOIN and FILTER (their own bodies) and with
    ``obs="off"``.
    """
    opts = ExecOptions.resolve(options, tune=tune, plan_cache=plan_cache,
                               decode=decode, obs=obs)
    opts.require_unset("run_query", "mode", "shards", "pass2",
                       "apply_block")
    tune = opts.tune if opts.tune is not None else "off"
    _check_tune(tune, mesh)
    decode = opts.decode if opts.decode is not None else "auto"
    if spec.kind == "join":
        return _run_join(spec, tables, mesh, axis, dict(spec.params))
    if spec.kind == "filter":
        return _run_filter(spec, tables, dict(spec.params))
    algo, streams, encs, params, complete = _prepare(spec, tables, decode)
    # encoded streams carry codes, pruned in code space
    r = _engine_call(algo, streams, mesh, axis, params, tune,
                     opts.plan_cache, encoding=encs, obs=opts.obs)
    out = complete(r)
    out["report"] = r.report
    return out


def _group_key(spec: QuerySpec):
    """Batching key: specs batch together only when their streams and
    family statics agree (same columns, policy, score or agg, and the same
    side of the hash's 2^16 multiply-shift / modulo branch, a static of
    ``core.batched``). None for JOIN and FILTER, which run on their own."""
    k, p = spec.kind, spec.params
    if k == "distinct":
        return (k, spec.columns, p.get("policy", "lru"),
                int(p["d"]) < (1 << 16))
    if k == "topn":
        if p.get("mode", "rand") == "rand":
            return (k, spec.columns, "rand", int(p["d"]) < (1 << 16))
        return (k, spec.columns, "det")
    if k == "skyline":
        return (k, spec.columns, p.get("score", "aph"))
    if k == "groupby":
        return (k, spec.columns, p.get("agg", "sum"),
                int(p["d"]) < (1 << 16))
    if k == "having":
        return (k, spec.columns, p.get("agg", "sum"))
    return None


def _trim_cols(a: torch.Tensor, d: int, w: int, w_cap: int) -> torch.Tensor:
    """[d_cap, L * w_cap] -> [d, L * w]: each block of w_cap columns (a lane's
    slots) cut to its first w, the rows to the first d."""
    return a.reshape(a.shape[0], -1, w_cap)[:d, :, :w].reshape(d, -1)


def run_queries(specs, tables, mesh=None, axis: str = "data",
                device_budget_bytes: int | None = None,
                tune: str | None = None, plan_cache=None,
                options: ExecOptions | None = None,
                decode: str | None = None,
                obs: str | None = None) -> list:
    """Execute many queries, batching compatible ones into one program.

    Specs are grouped by ``_group_key`` (same family, columns and family
    statics); each group of two or more runs through
    ``core.engine_prune_batch`` in ``scan`` mode (one lane over the shared
    stream for every query of the group), or with a mesh in ``mesh`` mode,
    pass 2 resident on the workers: one gather of the group's states a
    wave. Singleton groups, JOIN and FILTER run through ``run_query``.
    Results come back in input order, one ``run_query``-shaped dict a
    spec, equal to a serial ``run_query`` loop; every member of a group
    shares the group's ``ExecReport``.

    device_budget_bytes caps each group's resident switch state (§8):
    an oversubscribed group runs in admission waves
    (``planner.plan_query_batch``).

    tune: ``"off"`` | ``"cached"`` | ``"race"``. Each group of two or more
    resolves ONE plan, on the group's shared streams with its first
    query's parameters, and runs the whole batch through it
    (``core.execute_plan_batch``); singletons tune query by query. The
    answers are exact either way, though a group's masks may differ from
    a serial loop tuned query by query, since the group shares one S. It
    cannot be combined with ``mesh=``.
    """
    opts = ExecOptions.resolve(options, tune=tune, plan_cache=plan_cache,
                               decode=decode, obs=obs)
    opts.require_unset("run_queries", "mode", "shards", "pass2",
                       "apply_block")
    tune = opts.tune if opts.tune is not None else "off"
    plan_cache = opts.plan_cache
    _check_tune(tune, mesh)
    decode = opts.decode if opts.decode is not None else "auto"
    obs = opts.obs
    specs = list(specs)
    results: list = [None] * len(specs)
    groups: dict = {}
    for i, spec in enumerate(specs):
        key = _group_key(spec)
        if key is None:
            results[i] = run_query(spec, tables, mesh, axis, decode=decode,
                                   obs=obs)
        else:
            groups.setdefault(key, []).append(i)
    for idxs in groups.values():
        if len(idxs) == 1:
            results[idxs[0]] = run_query(specs[idxs[0]], tables, mesh, axis,
                                         tune=tune, plan_cache=plan_cache,
                                         decode=decode, obs=obs)
            continue
        prepped = [_prepare(specs[i], tables, decode) for i in idxs]
        algo, streams, encs = prepped[0][0], prepped[0][1], prepped[0][2]
        queries = [pr[3] for pr in prepped]
        if tune != "off":
            tr = core.resolve_plan(algo, streams, queries[0],
                                   tune_mode=tune, cache=plan_cache,
                                   obs=obs)
            rb = core.execute_plan_batch(
                algo, queries, *streams, plan=tr.plan, encoding=encs,
                device_budget_bytes=device_budget_bytes, obs=obs)
        elif mesh is None:
            rb = core.engine_prune_batch(
                algo, queries, *streams, mode="scan", encoding=encs,
                device_budget_bytes=device_budget_bytes, obs=obs)
        else:
            rb = core.engine_prune_batch(
                algo, queries, *streams, mode="mesh",
                shards=mesh.shape[axis], mesh=mesh, mesh_axis=axis,
                pass2="mesh", encoding=encs,
                device_budget_bytes=device_budget_bytes, obs=obs)
            rb.keep = core.unshard_mask_batch(rb.keep, streams[0].shape[0],
                                              mesh)
        w_cap = (max(int(q["w"]) for q in queries)
                 if algo == "groupby" else None)
        for j, i in enumerate(idxs):
            state_j = core.batched.take(rb.state, j)
            if algo == "groupby":
                # trim the batch-cap pads (never-valid slots) back to the
                # query's own (d, w), so that completion and the traffic
                # count see the serial state's shape; the columns come in
                # blocks of the batch's w cap, one a lane (one in scan)
                d, w = int(queries[j]["d"]), int(queries[j]["w"])
                state_j = dataclasses.replace(state_j, **{
                    f.name: _trim_cols(getattr(state_j, f.name), d, w, w_cap)
                    for f in dataclasses.fields(state_j)})
            rj = core.PruneResult(
                keep=rb.keep[j], state=state_j,
                emitted=core.batched.take(rb.emitted, j))
            results[i] = prepped[j][4](rj)
            # one batched dispatch served the whole group
            results[i]["report"] = rb.report
    return results


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
