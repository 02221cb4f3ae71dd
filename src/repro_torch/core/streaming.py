"""Streaming pruning engine: resident, in-place switch state.

``core/engine.py`` is one-shot: an arrival pattern must be buffered into
one materialised stream before any pruning happens. The paper's deployment
is a continuous packet stream flowing through resident switch state.
``PruneStream`` / ``engine_prune_stream`` bring that shape to the engine,
with the JAX package's names, arguments and contract
(``src/repro/core/streaming.py``), on one device:

fold
    Each micro-batch is split into S contiguous chunks (chunk j extends
    lane j's stream) and folded into the S stacked lane states by the
    algorithms' resumed pass-1 kernels (``_AlgoSpec.resume``), which read
    the carried states at entry and write them back in place: the states'
    ``data_ptr`` stay the same from fold to fold, the counterpart of the
    reference's donated buffers (``donate=False`` allocates a fresh state
    every fold). The fold takes tensors on the device and reads nothing
    back to the host (the tail pads are made with torch; the first ragged
    fold reads the constant pad fills once). Each fold's live mask joins a
    window of CUDA events on the current stream: ``_drain`` polls
    ``event.query()``, and only a full window waits, on its oldest event.
    On the CPU every mask is ready at once.

merge
    Every K micro-batches (``merge_every``; ``"auto"`` resolves K from the
    measured merge cost through ``planner.optimal_merge_interval``) the
    lane states are merged (``_AlgoSpec.merge``). The merged snapshot never
    shares memory with the lane states, which the next fold overwrites.

emit
    Each fold emits a live keep mask for its micro-batch from the apply
    bodies, judged against the latest merged snapshot (the lanes' pass-1
    masks before the first merge). A stale snapshot only loosens the mask,
    except HAVING's running sketch, which underestimates the final count:
    its live mask is all True and it prunes at close.

close
    One final merge, then every stored micro-batch is filtered again
    against the final merged state (each batch's ``_index_offset`` keeps
    the positional hashes aligned), so ``close().keep`` equals one-shot
    ``engine_prune(mode="two_pass")`` on the lane-view stream (``lane_view``)
    bit for bit, at every merge interval.

mesh
    ``mesh=`` spreads the S lanes over the positions of a
    ``core.mesh.Mesh``, S/D lanes a position (default ``shards``: the
    mesh's position count, as in the reference). Each position folds its
    own lanes, the merge gathers the lane states with ``mesh.all_gather``
    (S x one lane's state bytes to each of the D positions), and every
    pass 2 runs on each position's lanes with their global lane base. The
    mesh's collectives are never in flight two at a time, so the
    reference's multiprocess fence (``src/repro/core/streaming.py:185-210``)
    has no counterpart. Across processes ``close()`` gathers every
    process's masks and emissions, so its result is whole in each;
    ``live_masks()`` and ``lane_state`` are this process's lanes.

Without a mesh the lanes run on the streams' device, and the default
``shards`` is the device count of the port's device (the card's, or 1 on
the CPU), where the reference takes ``len(jax.devices())``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch

from ..kernels.ops import _pad_to
from ..obs import report as obsreport
from . import planner
from .encoding import as_x32, normalize_encodings
from .engine import (_FIRST_ELEMENT_PADS, _SPECS, _apply_chunked,
                     _decode_streams, _encoded_spec, _mesh_lanes,
                     _padded_encodings, _state_nbytes, calibrate_merge_cost)
from .mesh import to_device
from .options import ExecOptions


@dataclasses.dataclass
class StreamResult:
    """What a drained stream hands the master.

    keep:      bool[m] final masks in arrival order, bit-identical to
               one-shot ``engine_prune`` over the lane-view stream.
    live_keep: bool[m] the provisional masks emitted on the hot path.
    state:     the final merged global state (``merge_states`` output).
    emitted:   the per-batch emissions (GROUP BY evictions), concatenated,
               each batch in its padded lane layout as the one-shot engine.
    stats:     batches / entries / merges / window_blocks.
    report:    the stream's ``ExecReport`` (None when obs="off").
    """

    keep: torch.Tensor
    live_keep: torch.Tensor
    state: Any = None
    emitted: Any = None
    stats: dict = dataclasses.field(default_factory=dict)
    report: Any = None


def default_shards() -> int:
    """The lanes a stream takes by default: the port's device count."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _tensor_fields(state):
    return [(f.name, getattr(state, f.name)) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


def _clone_state(state):
    return dataclasses.replace(state, **{n: t.clone() for n, t in
                                         _tensor_fields(state)})


def _unaliased(merged, states: list):
    """``merged`` with every tensor that shares memory with a lane state
    copied (a merge may return a view, as ``cols_by_shard`` does at S = 1)."""
    lanes = {t.untyped_storage().data_ptr() for state in states
             for _, t in _tensor_fields(state)}
    return dataclasses.replace(merged, **{
        n: t.clone() for n, t in _tensor_fields(merged)
        if t.untyped_storage().data_ptr() in lanes})


class PruneStream:
    """S resident switch lanes folding micro-batches as they arrive.

    Usage::

        stream = PruneStream("topn_det", shards=8, N=100, w=8)
        for batch in arrivals:
            stream.fold(batch)        # returns the batch index
        res = stream.close()          # final merge + exact refresh

    merge_every: the cross-lane merge period K in micro-batches; 1 merges
    after every fold (the tightest live masks), ``"auto"`` resolves K from
    the measured merge cost. window: the most live masks in flight before a
    fold waits on the oldest. retain=False drops each micro-batch after its
    fold (an unbounded stream): close() then returns the live masks as
    ``keep``.
    """

    def __init__(self, algo: str, *, options: ExecOptions | None = None,
                 shards: int | None = None, mesh=None,
                 mesh_axis: str = "shards", merge_every: int | str = "auto",
                 window: int = 4, donate: bool = True,
                 apply_block: int | None = None, retain: bool = True,
                 encoding=None, obs: str | None = None, **params):
        opts = ExecOptions.resolve(options, shards=shards,
                                   apply_block=apply_block, obs=obs)
        opts.require_unset("PruneStream", "mode", "pass2", "tune",
                           "plan_cache")
        shards = opts.shards
        self.algo = algo
        self._spec = _SPECS[algo]  # KeyError = unknown algorithm
        self._encoding = encoding
        self._decode = opts.decode if opts.decode is not None else "auto"
        self._enc_wrapped = encoding is None
        if shards is not None and not isinstance(shards, int):
            raise ValueError(f"PruneStream needs a concrete lane count, got "
                             f"shards={shards!r}")
        if shards is None:
            shards = (mesh.shape[mesh_axis] if mesh is not None
                      else default_shards())
        self.shards = int(shards)
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        self.mesh = mesh
        if mesh is None:
            # one position holding every lane, on the streams' device
            self._lanes_pos = self.shards
            self._pos = [(None, 0)]
        else:
            self._lanes_pos = _mesh_lanes(self.shards,
                                          mesh.shape[mesh_axis])
            self._pos = mesh.positions(self._lanes_pos)
        # this process's first global lane
        self._g_first = 0 if mesh is None else mesh.first * self._lanes_pos
        self.params = dict(params)
        self._apply_block = opts.apply_block
        self.merge_every = merge_every
        self.window = int(window)
        self.donate = bool(donate)
        self.retain = bool(retain)
        self._obs_level = opts.obs
        self._fills = None          # the constant pad fills, read once
        self.stats = dict(batches=0, entries=0, merges=0, window_blocks=0)
        self._merge_k: int | None = None
        self.reset()

    # ------------------------------------------------------------- plumbing
    def _lanes(self, streams: tuple, nb: int) -> tuple:
        """The batch's S lanes [S, nb, ...], the tail padded as the one-shot
        engine pads it: with the stream's first element where the algorithm
        pads so (HAVING and GROUP BY keys), else with the constant fill."""
        S = self.shards
        pad = S * nb - streams[0].shape[0]
        if pad and self._fills is None:
            self._fills = self._spec.pads(tuple(s[:1] for s in streams),
                                          self.params)
        first = _FIRST_ELEMENT_PADS.get(self.algo, ())
        out = []
        for i, s in enumerate(streams):
            if pad and i in first:
                s = torch.cat([s, s[:1].expand((pad,) + tuple(s.shape[1:]))])
            elif pad:
                s = _pad_to(s, S, self._fills[i])[0]
            out.append(s.reshape((S, nb) + tuple(s.shape[1:])))
        return tuple(out)

    def _home(self, lanes: tuple):
        """The device the stream's masks and merged state live on."""
        return lanes[0].device if self.mesh is None else self.mesh.devices[0]

    def _local(self, lanes: tuple, g0: int, dev) -> tuple:
        """A position's lanes [g0, g0 + S/D) of the batch, on its device."""
        L = self._lanes_pos
        return tuple(x[g0:g0 + L] if dev is None else x[g0:g0 + L].to(dev)
                     for x in lanes)

    def _init_state(self, lanes: tuple) -> list:
        """Each position's empty lane states [S/D, ...], on its device."""
        lane = self._spec.init(lanes, self.params)
        L = self._lanes_pos
        return [to_device(dataclasses.replace(lane, **{
            n: t[None].expand((L,) + tuple(t.shape)).clone()
            for n, t in _tensor_fields(lane)}), dev or lanes[0].device)
            for dev, _ in self._pos]

    def _join(self, parts: list, home):
        """This process's per-position pieces joined along the lane axis."""
        if len(parts) == 1:
            return parts[0]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat([p[i].to(home) for p in parts])
                         for i in range(len(parts[0])))
        return torch.cat([p.to(home) for p in parts])

    def _resolve_merge_k(self, batch_entries: int, streams: tuple) -> int:
        if self._merge_k is None:
            if isinstance(self.merge_every, int):
                self._merge_k = max(1, self.merge_every)
            elif self.merge_every == "auto":
                c, state_bytes = calibrate_merge_cost(
                    self.algo, tuple(s[:1] for s in streams), self.params)
                self._merge_k = planner.optimal_merge_interval(
                    batch_entries,
                    merge_cost_entries=c * self.shards * state_bytes)
            else:
                raise ValueError(
                    f"merge_every must be an int or 'auto', "
                    f"got {self.merge_every!r}")
        return self._merge_k

    def _apply(self, merged: dict, lanes, keep1, offset):
        """Each position's pass 2 on its lanes of the batch (global lane
        base g0), against ``merged[device]``: this process's keep."""
        block = self._apply_block
        home = self._home(lanes)
        L = self._lanes_pos
        out = []
        for dev, g0 in self._pos:
            local = self._local(lanes, g0, dev)
            k1 = None if keep1 is None else keep1[g0 - self._g_first:
                                                  g0 - self._g_first + L]
            k1 = None if k1 is None else k1.to(local[0].device)
            p = dict(self.params, _index_offset=offset, _lane0=g0)
            mg = merged[local[0].device]
            if block and self._spec.chunkable and block < lanes[0].shape[1]:
                out.append(_apply_chunked(self._spec.apply, self._spec.pads,
                                          mg, local, k1, p, block))
            else:
                out.append(self._spec.apply(mg, local, k1, p))
        return self._join(out, home)

    # ------------------------------------------------------------- hot path
    def fold(self, *streams) -> int:
        """Fold one micro-batch into the lane states; returns its index.

        The call launches the fold (and the merge when due) and the live
        mask, and returns without waiting unless the in-flight window is
        full. The live mask lands in ``live_masks()[idx]``.
        """
        if self._closed:
            raise RuntimeError("stream is closed")
        streams = tuple(as_x32(s) for s in streams if s is not None)
        if not self._enc_wrapped and self._decode == "eager":
            streams = _decode_streams(
                streams, normalize_encodings(self._encoding, len(streams)))
        b = int(streams[0].shape[0])
        if b == 0:
            raise ValueError("empty micro-batch")
        S = self.shards
        nb = -(-b // S)
        if self._spec.pad_validity and len(streams) < 3:
            # always appended, so that every micro-batch has the column and
            # the lane-view stream matches a one-shot call with it
            streams = streams + (torch.ones(b, dtype=torch.bool,
                                            device=streams[0].device),)
        if not self._enc_wrapped and self._decode != "eager":
            # wrap once, at the final stream count: every later body decodes
            # its lanes, and the ragged pads become codes
            encs = _padded_encodings(
                self.algo, self._spec,
                normalize_encodings(self._encoding, len(streams)),
                tuple(s[:1] for s in streams), self.params)
            self._spec = _encoded_spec(self.algo, self._spec, encs)
            self._enc_wrapped = True
        lanes = self._lanes(streams, nb)
        if self._state is None:
            self._state = self._init_state(lanes)
        K = self._resolve_merge_k(S * nb, streams)
        off = self._offset
        t = len(self._batches)
        rec = self._rec
        with rec.span("fold_dispatch", batch=t, entries=b):
            if not self.donate:
                self._state = [_clone_state(st) for st in self._state]
            p = dict(self.params, _index_offset=off)
            parts = [self._spec.resume(st, self._local(lanes, g0, dev), p)
                     for st, (dev, g0) in zip(self._state, self._pos)]
            home = self._home(lanes)
            keep1 = (None if parts[0][0] is None
                     else self._join([r[0] for r in parts], home))
            emitted = (None if parts[0][2] is None
                       else self._join([r[2] for r in parts], home))
        if (t + 1) % K == 0:
            with rec.span("merge_dispatch", batch=t):
                self._merged = self._merge_now()
            self._count_merge(t)
        keep_live = self._live_mask(lanes, keep1, off, nb)
        if rec.active:
            rec.count("entries_scanned", b)
            staleness = (t - self._last_merge_t if self._last_merge_t >= 0
                         else t + 1)
            rec.observe("snapshot_staleness_batches", staleness)
        self._batches.append(dict(
            lanes=lanes if self.retain else None,
            keep1=keep1 if self.retain else None,
            keep_live=keep_live, emitted=emitted, b=b, nb=nb, offset=off))
        self._offset += nb
        self.stats["batches"] += 1
        self.stats["entries"] += b
        self._enqueue(keep_live)
        if rec.active:
            rec.observe("window_occupancy", len(self._pending))
        return t

    def _merge_now(self):
        """The merged snapshot, on the home device (and, in
        ``_merged_on``, on every device of a position): one gather of the
        lane states over the mesh, then every device folds the same
        merge."""
        if self.mesh is None:
            st = self._state[0]
            merged = _unaliased(self._spec.merge(st, self.params),
                                self._state)
            self._merged_on = {_tensor_fields(st)[0][1].device: merged}
            return merged
        gathered = self.mesh.all_gather(self._state)
        self._merged_on = self.mesh.replicate(gathered, lambda g: _unaliased(
            self._spec.merge(g, self.params), self._state))
        return self._merged_on[self.mesh.devices[0]]

    def _live_mask(self, lanes, keep1, offset, nb):
        if self._spec.sharded_needs_merge:
            # HAVING: the running sketch underestimates the final count, so
            # pruning on it could drop a key that qualifies later
            return torch.ones((self._lanes_pos * len(self._pos), nb),
                              dtype=torch.bool, device=self._home(lanes))
        if self._merged is None:
            return keep1
        return self._apply(self._merged_on, lanes, keep1, offset)

    def _enqueue(self, mask: torch.Tensor) -> None:
        event = None
        if mask.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(mask.device))
        self._pending.append(event)
        self._drain()
        while len(self._pending) > self.window:
            self.stats["window_blocks"] += 1
            self._pending.popleft().synchronize()
            self._drain()

    def _drain(self) -> None:
        while self._pending and (self._pending[0] is None
                                 or self._pending[0].query()):
            self._pending.popleft()

    def _count_merge(self, t: int | None = None) -> None:
        """Book one cross-lane merge: stats and telemetry. On one device a
        merge reads the lanes' stacked states once; the mesh's gather lands
        every lane's state on each of its D positions: S x one lane's bytes
        x D."""
        self.stats["merges"] += 1
        if t is not None:
            self._last_merge_t = t
        rec = self._rec
        if rec.active and self._state is not None:
            rec.count("merge_collective_count", 1)
            nbytes = sum(_state_nbytes(st) for st in self._state)
            if self.mesh is not None:
                nbytes *= self.mesh.world * self.mesh.size
            rec.count("state_bytes_shipped", nbytes)

    # ------------------------------------------------------------- queries
    def merge(self):
        """Force a cross-lane merge now; returns the merged state."""
        if self._state is None:
            raise RuntimeError("nothing folded yet")
        with self._rec.span("merge_dispatch", forced=True):
            self._merged = self._merge_now()
        self._count_merge(len(self._batches) - 1)
        return self._merged

    def live_masks(self) -> list:
        """Per-batch live keep masks in arrival order, flattened (across
        processes: this process's lanes)."""
        return [b["keep_live"].reshape(-1)[:b["b"]] for b in self._batches]

    def live_mask(self, idx: int) -> torch.Tensor:
        """One batch's live keep mask (arrival order, real entries)."""
        rec = self._batches[idx]
        return rec["keep_live"].reshape(-1)[: rec["b"]]

    @property
    def in_flight(self) -> int:
        self._drain()
        return len(self._pending)

    @property
    def lane_state(self):
        """The S stacked lane states (updated in place by every fold). On a
        mesh: this process's lanes, a copy joined from its positions'."""
        if self._state is None or self.mesh is None:
            return None if self._state is None else self._state[0]
        home = self.mesh.devices[0]
        return dataclasses.replace(self._state[0], **{
            n: torch.cat([getattr(st, n).to(home) for st in self._state])
            for n, _ in _tensor_fields(self._state[0])})

    def reset(self):
        """Drop the stream's state and batches (keeps the lane count, the
        merge period once resolved and the encodings' wrapping)."""
        self._state = None
        self._merged = None
        self._merged_on = None
        self._offset = 0
        self._batches: list[dict] = []
        self._pending: collections.deque = collections.deque()
        self._closed = False
        self._result: StreamResult | None = None
        self._last_merge_t = -1
        self._rec = obsreport.recorder("prune_stream", self._obs_level)

    # --------------------------------------------------------------- close
    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        """A batch's [S_proc, nb] lanes of this process, joined with every
        other process's (the O(m) bools of a mask: never the entries)."""
        if self.mesh is None or self.mesh.world == 1:
            return x
        return self.mesh.all_gather([x])

    def close(self) -> StreamResult:
        """Final merge and exact refresh of every stored micro-batch: the
        scan-free filter again with the final merged state and each batch's
        positional offset, which is why the result is bit-identical to
        one-shot ``engine_prune`` on the lane-view stream at any merge
        interval."""
        if self._result is not None:
            return self._result
        self._closed = True
        orec = self._rec
        if not self._batches:
            empty = torch.zeros(0, dtype=torch.bool)
            self._result = StreamResult(
                keep=empty, live_keep=empty, stats=dict(self.stats),
                report=orec.finish() if orec.active else None)
            return self._result
        merged = self.merge()
        keeps, lives = [], []
        with orec.span("close_refresh", batches=len(self._batches)):
            for rec in self._batches:
                live = self._whole(rec["keep_live"]).reshape(-1)[: rec["b"]]
                if self.retain:
                    keep = self._apply(self._merged_on, rec["lanes"],
                                       rec["keep1"], rec["offset"])
                    keeps.append(self._whole(keep).reshape(-1)[: rec["b"]])
                else:
                    keeps.append(live)
                lives.append(live)
            orec.sync(keeps)
        emitted = None
        if self._batches[0]["emitted"] is not None:
            # emissions keep each batch's whole padded lane layout, as the
            # one-shot engine's do (a pad can evict a real partial)
            emitted = tuple(
                torch.cat([self._whole(r["emitted"][i]).reshape(-1)
                           for r in self._batches])
                for i in range(len(self._batches[0]["emitted"])))
        keep_cat = torch.cat(keeps)
        report = None
        if orec.active:
            orec.annotate(algo=self.algo, shards=self.shards,
                          merge_every=self._merge_k,
                          batches=self.stats["batches"],
                          window_blocks=self.stats["window_blocks"])
            orec.count("entries_kept", int(keep_cat.sum()))
            report = orec.finish()
        self._result = StreamResult(
            keep=keep_cat, live_keep=torch.cat(lives), state=merged,
            emitted=emitted, stats=dict(self.stats), report=report)
        return self._result


def engine_prune_stream(algo: str, *streams, micro_batch: int = 4096,
                        options: ExecOptions | None = None,
                        shards: int | None = None, mesh=None,
                        mesh_axis: str = "shards",
                        merge_every: int | str = "auto", window: int = 4,
                        donate: bool = True, apply_block: int | None = None,
                        encoding=None, obs: str | None = None,
                        **params) -> StreamResult:
    """One-shot entry point: cut ``streams`` into micro-batches of
    ``micro_batch`` entries and run them through a ``PruneStream``; the
    returned ``keep`` is in arrival order over the m entries."""
    stream = PruneStream(algo, options=options, shards=shards, mesh=mesh,
                         mesh_axis=mesh_axis, merge_every=merge_every,
                         window=window, donate=donate,
                         apply_block=apply_block, encoding=encoding,
                         obs=obs, **params)
    streams = [s for s in streams if s is not None]
    m = streams[0].shape[0]
    for lo in range(0, m, micro_batch):
        stream.fold(*(s[lo:lo + micro_batch] for s in streams))
    return stream.close()


def lane_view(algo: str, streams, batch_sizes, shards: int, **params):
    """The lane-major stream a PruneStream folds, for holding it against
    the one-shot engine: ``(lane_streams, valid, arrival)``, the per-lane
    streams concatenated (length S * L, the mid-stream pads included, the
    GROUP BY validity column appended), a bool mask of the real entries and
    each lane-view entry's arrival index (-1 for a pad). With ``one =
    engine_prune(algo, *lane_streams, mode="two_pass", shards=S)``::

        one.keep[valid] == close().keep[arrival[valid]]
    """
    spec = _SPECS[algo]
    streams = [as_x32(torch.as_tensor(s)) for s in streams if s is not None]
    m = streams[0].shape[0]
    sizes = list(batch_sizes)
    if sum(sizes) != m:
        raise ValueError(f"batch_sizes sum {sum(sizes)} != stream length {m}")
    dev = streams[0].device
    per_lane: list[list[list]] = []
    idx_lane: list[list] = [[] for _ in range(shards)]
    lo = 0
    for b in sizes:
        batch = [s[lo:lo + b] for s in streams]
        if spec.pad_validity and len(batch) < 3:
            batch.append(torch.ones(b, dtype=torch.bool, device=dev))
        if not per_lane:
            per_lane = [[[] for _ in range(shards)] for _ in batch]
        nb = -(-b // shards)
        pad = shards * nb - b
        if pad:
            fills = spec.pads(tuple(batch), params)
            batch = [_pad_to(s, shards, f)[0] for s, f in zip(batch, fills)]
        arrival = torch.cat([torch.arange(lo, lo + b, device=dev),
                             torch.full((pad,), -1, device=dev)])
        for j in range(shards):
            for si, s in enumerate(batch):
                per_lane[si][j].append(s[j * nb:(j + 1) * nb])
            idx_lane[j].append(arrival[j * nb:(j + 1) * nb])
        lo += b
    lane_streams = tuple(torch.cat([torch.cat(per_lane[si][j])
                                    for j in range(shards)])
                         for si in range(len(per_lane)))
    arrival = torch.cat([torch.cat(idx_lane[j]) for j in range(shards)])
    return lane_streams, arrival >= 0, arrival
