"""Multi-query batching: Q same-family queries over shared streams as one
program (``engine_prune_batch``; the JAX package's
``core/engine.py:1238-1590``).

Cheetah's switch serves many concurrent queries over one entry stream
(paper §6). ``engine_prune_batch`` runs the queries of one family over the
stream's lanes together, each family's bodies in ``core.batched``: every
shape parameter padded to the batch's cap, every value parameter the
query's own, each query's keep bit-identical to its serial
``engine_prune``. Three modes:

``scan``      one lane over the whole stream for every query; the state is
              each query's lane state [Q, ...] at the batch's caps.
``two_pass``  S lanes for every query (pass 1 of the whole wave), then each
              query's merge and pass 2; the state is each query's merged
              state, GROUP BY's emissions are [Q, S * ceil(m/S)].
``mesh``      the S lanes over the positions of a ``core.mesh.Mesh``:
              each position runs the wave's pass 1 (the batched walks) on
              its own lanes. ``pass2="mesh"`` (the default here) gathers
              only the wave's states, a leading Q axis on every leaf, so
              ONE gather a leaf serves the whole wave; every device folds
              each query's merge and each position filters its own lanes
              (keep stacked [Q, S, n], ``unshard_mask_batch`` flattens).
              ``pass2="master"`` gathers masks, states and emissions to
              the master, which filters the whole stream.

``device_budget_bytes`` charges each query its padded switch state times
the lanes that ship it (``state_bytes`` of the family, from the caps and
the decoded streams' dtypes), and ``planner.plan_query_batch`` splits the
batch into admission waves that fit (a query above the budget runs
alone); every wave runs at the batch's caps, so the waves concatenate
along Q. Telemetry as the reference records it: a span a wave, and in
``two_pass`` and ``mesh`` one merge collective and the wave's state bytes
a wave (times the positions when pass 2 is resident).

``execute_plan_batch`` runs one tuned ``planner.Plan`` for the whole
batch (``query.run_queries(tune=)``): two_pass, or mesh on the plan's
device spread, at the plan's S and chunk.

``tune=`` and ``plan_cache=`` are refused as the reference refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..obs import report as obsreport
from . import batched, planner
from . import engine as E
from .encoding import as_x32, normalize_encodings
from .options import ExecOptions

MODES_BATCH = ("scan", "two_pass", "mesh")


@dataclasses.dataclass
class BatchPruneResult:
    """Q queries' worth of ``PruneResult``, a leading axis Q on every
    tensor: keep bool[Q, m]; state and emitted as ``engine_prune`` gives
    them for the mode, padded to the batch's caps (a query with w=3 in a
    batch of w 8 reports an 8-wide state whose slots past 3 are inert
    pads). ``plan``: the admission plan (``planner.QueryBatchPlan``)."""

    keep: torch.Tensor
    state: Any = None
    emitted: Any = None
    plan: Any = None

    # telemetry (``repro_torch.obs.ExecReport``), attached after the run
    report = None


def unshard_mask_batch(keep: torch.Tensor, m: int, mesh=None
                       ) -> torch.Tensor:
    """Stacked [Q, S, n] batch keep masks -> flat bool[Q, m]: per query,
    the lanes in stream order, the tail pads dropped. With the ``mesh`` of
    a resident pass 2 across processes (each holding its own lanes), the
    processes' lanes are gathered first, as ``engine.unshard_mask`` does."""
    if mesh is not None and mesh.world > 1:
        keep = mesh.all_gather([keep], dim=1)
    return keep.reshape(keep.shape[0], -1)[:, :m]


def _decoded_meta(streams, encs) -> list:
    """(dtype, trailing shape) of each stream as the bodies see it (an
    encoded stream by its dictionary's values)."""
    return [((s.dtype if e is None else e.lut.dtype), tuple(s.shape[1:]))
            for s, e in zip(streams, encs)]


def _batch_query_bytes(bspec, caps, streams, encs, lanes: int) -> int:
    """One query's resident state charge: its padded lane state (the
    batch's caps, the decoded streams' dtypes) times the lanes shipped."""
    return bspec.state_bytes(caps, _decoded_meta(streams, encs)) * lanes


def _encoded_bspec(bspec, encs):
    """The batched bodies on dictionary-encoded lanes: pass 1 and pass 2
    decode their lanes with one ``lut[code]`` gather at entry."""
    def dec(lanes):
        return E._decode_streams(lanes, encs)

    return dataclasses.replace(
        bspec,
        pass1=lambda ln, qps, caps, full: bspec.pass1(dec(ln), qps, caps,
                                                      full),
        apply=lambda mg, ln, k1, q, caps: bspec.apply(mg, dec(ln), k1, q,
                                                      caps))


def _run_wave_scan(bspec, streams, qps, caps):
    """One lane over the whole stream for every query of the wave:
    (keep [Q, m], lane states [Q, ...], emitted [Q, m] each or None)."""
    keep, st, ev = bspec.pass1(tuple(s.contiguous()[None] for s in streams),
                               qps, caps, True)
    lane0 = lambda x: batched.take(x, (slice(None), 0))  # noqa: E731
    return (keep[:, 0], lane0(st),
            None if ev is None else tuple(e[:, 0] for e in ev))


def _apply_wave(bspec, pads_fn, lanes, qps, caps, apply_block, keep1,
                merged, lane0: int = 0) -> torch.Tensor:
    """Each query's pass 2 on ``lanes`` (global lanes from ``lane0``):
    keep [Q, S, n]."""
    keeps = []
    for i, q in enumerate(qps):
        q2 = dict(q, _lane0=lane0)
        if apply_block and bspec.chunkable \
                and apply_block < lanes[0].shape[1]:
            k2 = E._apply_chunked(
                lambda g, ln, k1, p, q=q2: bspec.apply(g, ln, k1, q, caps),
                pads_fn, merged[i], lanes, keep1[i], {}, apply_block)
        else:
            k2 = bspec.apply(merged[i], lanes, keep1[i], q2, caps)
        keeps.append(k2)
    return torch.stack(keeps)


def _pass2_master(bspec, pads_fn, lanes, qps, caps, apply_block, keep1, st,
                  ev):
    """Each query's merge, then its pass 2 over all S lanes (two_pass, and
    mesh mode's pass2="master"): (keep [Q, S, n], merged [Q, ...],
    emitted)."""
    merged = [bspec.merge(batched.take(st, i), q, caps)
              for i, q in enumerate(qps)]
    keep = _apply_wave(bspec, pads_fn, lanes, qps, caps, apply_block, keep1,
                       merged)
    return keep, batched.stack(merged), ev


def _run_wave_two_pass(bspec, pads_fn, lanes, qps, caps, apply_block):
    """Pass 1 of the wave's queries over S lanes, then each query's merge
    and pass 2: (keep [Q, S, n], merged states [Q, ...], emitted)."""
    keep1, st, ev = bspec.pass1(lanes, qps, caps, False)
    return _pass2_master(bspec, pads_fn, lanes, qps, caps, apply_block,
                         keep1, st, ev)


def _wave_pass1_parts(bspec, lanes, qps, caps, mesh):
    """Pass 1 of the wave on each position's own S/D lanes (the batched
    walks once a position): [(device, lane0, local lanes, (keep [Q, L, n],
    states [Q, L, ...], emitted))]."""
    L = E._mesh_lanes(lanes[0].shape[0], mesh.shape[mesh.axis])
    out = []
    for dev, g0 in mesh.positions(L):
        local = E._position_lanes(lanes, g0, L, dev)
        out.append((dev, g0, local, bspec.pass1(local, qps, caps, False)))
    return out


def _run_wave_mesh_master(bspec, pads_fn, lanes, qps, caps, mesh,
                          apply_block):
    """The wave's pass 1 on the mesh; its masks, states and emissions
    gathered to the master (lane axis 1), which merges and filters the
    whole stream for each query."""
    parts = _wave_pass1_parts(bspec, lanes, qps, caps, mesh)
    keep1, st, ev = (mesh.all_gather([p[3][i] for p in parts], dim=1)
                     for i in range(3))
    home = mesh.devices[0]
    return _pass2_master(bspec, pads_fn, tuple(s.to(home) for s in lanes),
                         qps, caps, apply_block, keep1, st, ev)


def _run_wave_mesh_resident(bspec, pads_fn, lanes, qps, caps, mesh,
                            apply_block):
    """Both passes of a whole wave on the mesh.

    Every lane state carries the wave's leading Q axis, so ONE gather a
    state leaf ships every query's states at once (not Q of them); every
    device folds each query's merge and each position applies it to its
    own lanes. Returns this process's keep [Q, S_proc, n], the merged
    states [Q, ...] and the emissions [Q, S_proc, n] on ``devices[0]``."""
    parts = _wave_pass1_parts(bspec, lanes, qps, caps, mesh)
    gathered = mesh.all_gather([p[3][1] for p in parts], dim=1)
    home = mesh.devices[0]
    merged = mesh.replicate(gathered, lambda g: [
        bspec.merge(batched.take(g, i), q, caps) for i, q in enumerate(qps)])
    keeps = [_apply_wave(bspec, pads_fn, local, qps, caps, apply_block,
                         r1[0], merged[dev], g0).to(home)
             for dev, g0, local, r1 in parts]
    ev = None
    if parts[0][3][2] is not None:
        ev = tuple(torch.cat([p[3][2][i].to(home) for p in parts], dim=1)
                   for i in range(len(parts[0][3][2])))
    return torch.cat(keeps, dim=1), batched.stack(merged[home]), ev


def _concat_waves(parts: list):
    """The waves' (keep, state, emitted) joined along Q."""
    if len(parts) == 1:
        return parts[0]
    keep, state, ev = zip(*parts)
    return (torch.cat(keep), batched.stack(list(state), torch.cat),
            None if ev[0] is None else batched.stack(list(ev), torch.cat))


def engine_prune_batch(algo: str, queries, *streams,
                       options: ExecOptions | None = None,
                       mode: str | None = None,
                       shards: int | None = None, mesh=None,
                       mesh_axis: str = "shards",
                       apply_block: int | None = None,
                       pass2: str | None = None,
                       encoding=None, decode: str | None = None,
                       obs: str | None = None,
                       device_budget_bytes: int | None = None
                       ) -> BatchPruneResult:
    """Run Q same-family queries over shared stream(s) as one program.

    queries: one param dict a query (the ``**params`` of a serial
    ``engine_prune``); N, w, d, thresholds and seeds may differ. The
    family statics (policy, score, agg, and the side of 2^16 of the hash's
    modulus) must agree: ``query.run_queries`` groups specs so that they
    do.

    mode: ``"scan"``, ``"two_pass"`` (the default) or ``"mesh"``
    (``mesh`` / ``mesh_axis`` / ``pass2`` as ``engine_prune`` takes them;
    pass2 defaults to ``"mesh"``, the point of batching on a mesh).
    ``shards`` must be a concrete lane count (None: 8, capped at m, or one
    lane a position in mesh mode; ``"auto"`` calibration is per query).
    ``apply_block`` chunks the DISTINCT and SKYLINE pass 2.
    ``encoding`` / ``decode`` as ``engine_prune``. ``obs``: the telemetry
    level; the report counts every query's entries.

    device_budget_bytes: the per-device budget of resident switch state
    (§8): each query is charged its padded state times its lanes, and the
    batch runs in admission waves that fit (``planner.plan_query_batch``).

    Returns ``BatchPruneResult``: keep bool[Q, m] (stacked [Q, S, n] when
    pass 2 ran resident), the plan attached.
    """
    opts = ExecOptions.resolve(options, mode=mode, shards=shards,
                               pass2=pass2, apply_block=apply_block,
                               decode=decode, obs=obs)
    opts.require_unset("engine_prune_batch", "tune", "plan_cache")
    mode = opts.mode if opts.mode is not None else "two_pass"
    shards = opts.shards
    pass2 = opts.pass2
    apply_block = opts.apply_block
    decode = opts.decode if opts.decode is not None else "auto"
    if mode not in MODES_BATCH:
        raise ValueError(
            f"mode must be one of {MODES_BATCH}, got {mode!r} "
            f"(mode='sharded' has no batched variant: use 'two_pass')")
    if pass2 is not None:
        if pass2 not in E.PASS2:
            raise ValueError(
                f"pass2 must be one of {E.PASS2}, got {pass2!r}")
        if mode != "mesh":
            raise ValueError(
                f"pass2={pass2!r} only applies to mode='mesh' "
                f"(got {mode!r})")
    bspec = batched.BSPECS[algo]  # KeyError = unknown algorithm
    spec = E._SPECS[algo]
    queries = list(queries)
    if not queries:
        raise ValueError("engine_prune_batch needs at least one query")
    qps, caps = bspec.build(queries)
    streams = tuple(as_x32(s) for s in streams if s is not None)
    encs = normalize_encodings(encoding, len(streams))
    if decode == "eager":
        streams = E._decode_streams(streams, encs)
        encs = (None,) * len(streams)
    encoded = any(e is not None for e in encs)
    m = streams[0].shape[0]
    ndev = ((mesh.shape[mesh_axis] if mesh is not None
             else E.default_positions(streams[0].device))
            if mode == "mesh" else 1)
    if shards is None:
        shards = ndev if mode == "mesh" else min(8, m)
    if not isinstance(shards, int) or isinstance(shards, bool):
        raise ValueError(
            f"engine_prune_batch needs a concrete lane count, got "
            f"shards={shards!r} ('auto' calibration is per-query)")
    scan_only = mode == "scan" or (shards <= 1 and mode != "mesh")

    if scan_only:
        if encoded:
            encs = E._padded_encodings(algo, spec, encs, streams, {})
            bspec = _encoded_bspec(bspec, encs)
        per_query = _batch_query_bytes(bspec, caps, streams, encs, 1)
        lanes = None
    else:
        if shards > m:
            raise ValueError(f"shards={shards} exceeds stream length {m}")
        if mode == "mesh" and mesh is None:
            mesh = E._mesh_for_shards(shards, mesh_axis, streams[0].device)
        if m % shards and spec.pad_validity and len(streams) < 3:
            streams = streams + (torch.ones(m, dtype=torch.bool,
                                            device=streams[0].device),)
            encs = encs + (None,)
        if encoded:
            encs = E._padded_encodings(algo, spec, encs, streams, {})
            spec = E._encoded_spec(algo, spec, encs)
            bspec = _encoded_bspec(bspec, encs)
        fills = (spec.pads(streams, {}) if m % shards
                 else (0,) * len(streams))
        lanes = tuple(E.shard_stack(s, shards, f)
                      for s, f in zip(streams, fills))
        if apply_block is None and mode == "mesh" and bspec.chunkable:
            apply_block = E.DEFAULT_MESH_APPLY_BLOCK
        per_query = _batch_query_bytes(bspec, caps, streams, encs, shards)

    plan = planner.plan_query_batch([per_query] * len(queries),
                                    device_budget_bytes)
    rec = obsreport.recorder("engine_prune_batch", opts.obs)
    if rec.active:
        rec.annotate(algo=algo, mode=mode, queries=len(queries),
                     shards=int(shards), m=int(m), encoded=encoded,
                     waves=len(plan.waves))

    p2 = None
    if mode == "mesh":
        p2 = pass2 or "mesh"
        if p2 == "auto":
            # the largest wave's resident gather; one placement for every
            # wave keeps the keep's layout uniform across waves
            p2 = planner.optimal_pass2(
                m, ndev, per_query * max(len(w) for w in plan.waves))
    resident = p2 == "mesh"

    parts = []
    for wi, wave in enumerate(plan.waves):
        qps_w = [qps[i] for i in wave]
        with rec.span(f"wave{wi}", queries=len(wave), mode=mode):
            if scan_only:
                parts.append(_run_wave_scan(bspec, streams, qps_w, caps))
            elif resident:
                parts.append(_run_wave_mesh_resident(
                    bspec, spec.pads, lanes, qps_w, caps, mesh, apply_block))
            elif mode == "mesh":
                parts.append(_run_wave_mesh_master(
                    bspec, spec.pads, lanes, qps_w, caps, mesh, apply_block))
            else:
                parts.append(_run_wave_two_pass(bspec, spec.pads, lanes,
                                                qps_w, caps, apply_block))
            rec.sync(parts[-1][0])
        if rec.active and not scan_only:
            # a wave's states cross together: one merge collective over all
            # its queries' states (per_query is S x one lane's bytes), and
            # the resident gather lands a copy on every position
            rec.count("merge_collective_count", 1)
            rec.count("state_bytes_shipped",
                      per_query * len(wave) * (ndev if resident else 1))
    keep, state, emitted = _concat_waves(parts)

    order = np.concatenate([np.asarray(w, np.int64) for w in plan.waves])
    if not np.array_equal(order, np.arange(len(queries))):
        inv = torch.from_numpy(np.argsort(order)).to(keep.device)
        keep = keep[inv]
        state = batched.take(state, inv)
        emitted = batched.take(emitted, inv)

    if not scan_only:
        # emissions keep the full padded length, flattened per query
        emitted = (None if emitted is None else
                   tuple(e.reshape(e.shape[0], -1) for e in emitted))
        if not resident:
            keep = unshard_mask_batch(keep, m)
    res = BatchPruneResult(keep=keep, state=state, emitted=emitted,
                           plan=plan)
    if rec.active:
        E._obs_mask_counts(rec, keep, m, encoded=encoded,
                           queries=len(queries),
                           partial=resident and mesh.world > 1)
        res.report = rec.finish()
    return res


def execute_plan_batch(algo: str, queries, *streams, plan,
                       encoding=None,
                       device_budget_bytes: int | None = None,
                       obs: str | None = None) -> BatchPruneResult:
    """Batched counterpart of ``engine.execute_plan``: one tuned plan for Q
    same-family queries over shared streams; keep comes back flat
    bool[Q, m] on the streams' device, wherever pass 2 ran."""
    streams = tuple(s for s in streams if s is not None)
    dev = streams[0].device
    kwargs = dict(shards=plan.shards, apply_block=plan.apply_block,
                  encoding=encoding, obs=obs,
                  device_budget_bytes=device_budget_bytes)
    mesh = None
    if plan.mode == "mesh":
        mesh = E.default_mesh("shards", num_devices=plan.num_devices,
                              device=dev)
        res = engine_prune_batch(algo, queries, *streams, mode="mesh",
                                 mesh=mesh, pass2=plan.pass2, **kwargs)
    else:
        res = engine_prune_batch(algo, queries, *streams, mode="two_pass",
                                 **kwargs)
    if res.keep.ndim == 3:  # resident pass 2: stacked [Q, S, n]
        res.keep = unshard_mask_batch(res.keep, int(streams[0].shape[0]),
                                      mesh)
    res.keep = res.keep.to(dev)
    return res
