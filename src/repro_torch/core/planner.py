"""The analytic query planner and multi-query packing (paper §3, §6, Table 2).

The planner computes a query's switch resource footprint from Table 2's
cost model, packs concurrent queries onto one pipeline (splitting per-stage
ALUs and SRAM, reusing stages across resource-orthogonal algorithms),
models S switch replicas and a merging master (``plan_multi_switch``,
``optimal_shards``: the lane count behind ``engine_prune(shards="auto")``),
places pass 2, admits query batches under a device budget and picks the
streaming merge period; that part is pure Python and touches no tensor.

The self-tuning plan search (``Plan``, ``analytic_plan``,
``candidate_plans``, ``tune``, ``resolve_plan``) races mask-preserving
engine plans on a prefix of the streams and keeps the winner in the plan
cache (``core.plancache``): ``two_pass`` and, when more than one mesh
position can host the lanes (``max_devices``, default every position
``core.mesh.default_mesh`` gives for the streams' device), ``mesh`` plans
with either pass-2 placement.
"""
from __future__ import annotations

import dataclasses
import math
import time

from ..obs import log as _obslog
from ..obs import report as obsreport
from .encoding import as_x32


@dataclasses.dataclass(frozen=True)
class SwitchProfile:
    """A PISA switch resource envelope (Tofino-like defaults)."""
    stages: int = 12
    alus_per_stage: int = 12          # 'A' in Table 2
    sram_per_stage_bytes: int = 1 << 20   # ~1 MB usable per stage
    tcam_entries: int = 100_000
    header_bytes: int = 20            # parsable bits budget per entry
    same_stage_shared_memory: bool = True  # needed by FIFO*/BF* variants


@dataclasses.dataclass(frozen=True)
class ResourceFootprint:
    """Table 2 row: per-algorithm switch consumption."""
    stages: int
    alus: int
    sram_bytes: int
    tcam: int = 0

    def __add__(self, o: "ResourceFootprint") -> "ResourceFootprint":
        return ResourceFootprint(self.stages + o.stages, self.alus + o.alus,
                                 self.sram_bytes + o.sram_bytes, self.tcam + o.tcam)


def footprint(algo: str, profile: SwitchProfile | None = None, **p) -> ResourceFootprint:
    """Resource model reproducing Table 2 (64-bit slots)."""
    prof = profile or SwitchProfile()
    A = prof.alus_per_stage
    slot = 8  # 64b
    if algo == "distinct_fifo":
        if not prof.same_stage_shared_memory:
            raise ValueError("FIFO* requires same-stage shared memory")
        d, w = p["d"], p["w"]
        return ResourceFootprint(math.ceil(w / A), w, d * w * slot)
    if algo == "distinct_lru":
        d, w = p["d"], p["w"]
        return ResourceFootprint(w, w, d * w * slot)
    if algo == "skyline_sum":
        D, w = p["D"], p["w"]
        return ResourceFootprint(math.ceil(math.log2(max(D, 2))) + 2 * w,
                                 2 * math.ceil(math.log2(max(D, 2))) - 1 + w * (D + 1),
                                 w * (D + 1) * slot)
    if algo == "skyline_aph":
        D, w = p["D"], p["w"]
        return ResourceFootprint(math.ceil(math.log2(max(D, 2))) + 2 * (w + 1),
                                 2 * math.ceil(math.log2(max(D, 2))) - 1 + w * (D + 1),
                                 w * (D + 1) * slot + (1 << 16) * 4, tcam=64 * D)
    if algo == "topn_det":
        w = p["w"]
        return ResourceFootprint(w + 1, w + 1, (w + 1) * slot)
    if algo == "topn_rand":
        d, w = p["d"], p["w"]
        return ResourceFootprint(w, w, d * w * slot)
    if algo == "groupby":
        d, w = p["d"], p["w"]
        return ResourceFootprint(w, w, d * w * slot)
    if algo == "join_bf":
        M, H = p["M"], p["H"]
        return ResourceFootprint(2, H, M)
    if algo == "having":
        d, w = p["d"], p["w"]  # d sketch rows, w counters each
        return ResourceFootprint(math.ceil(d / A), d, d * w * slot)
    if algo == "filter":
        n = p.get("num_predicates", 1)
        return ResourceFootprint(1, n, 4 * n)
    raise KeyError(algo)


@dataclasses.dataclass
class PackingPlan:
    """Concurrent placement of several queries on one pipeline (§6)."""
    placements: dict  # name -> (first_stage, footprint)
    stages_used: int
    feasible: bool
    reason: str = ""


def pack_queries(queries: dict[str, ResourceFootprint],
                 profile: SwitchProfile | None = None) -> PackingPlan:
    """First-fit-decreasing packing with per-stage ALU/SRAM budgets.

    Algorithms stack *in parallel* on the same stages when their combined
    per-stage ALU and SRAM demands fit (paper: filter shares a stage with
    GROUP BY's hashing/sums). Stage demand is modeled uniform across each
    algorithm's stage span.
    """
    prof = profile or SwitchProfile()
    alu_free = [prof.alus_per_stage] * prof.stages
    sram_free = [prof.sram_per_stage_bytes] * prof.stages
    tcam_free = prof.tcam_entries
    placements: dict = {}
    order = sorted(queries.items(), key=lambda kv: -kv[1].stages)
    hi = 0
    for name, fp in order:
        if fp.stages > prof.stages:
            return PackingPlan({}, 0, False, f"{name}: needs {fp.stages} stages > {prof.stages}")
        per_stage_alu = math.ceil(fp.alus / max(fp.stages, 1))
        per_stage_sram = math.ceil(fp.sram_bytes / max(fp.stages, 1))
        placed = False
        for s0 in range(prof.stages - fp.stages + 1):
            span = range(s0, s0 + fp.stages)
            if all(alu_free[s] >= per_stage_alu and sram_free[s] >= per_stage_sram
                   for s in span) and tcam_free >= fp.tcam:
                for s in span:
                    alu_free[s] -= per_stage_alu
                    sram_free[s] -= per_stage_sram
                tcam_free -= fp.tcam
                placements[name] = (s0, fp)
                hi = max(hi, s0 + fp.stages)
                placed = True
                break
        if not placed:
            return PackingPlan({}, 0, False, f"{name}: no feasible placement")
    # +1 final stage selecting the per-query prune bit (paper §6)
    return PackingPlan(placements, min(hi + 1, prof.stages), True)


@dataclasses.dataclass
class MultiSwitchPlan:
    """Placement of a workload on S switch replicas + a merging master.

    The engine's `sharded`/`two_pass` modes model exactly this: each of
    `shards` switches prunes a 1/S slice of the stream with the same
    per-switch footprint, then ships its final state to the master,
    which folds the S states (`merge_states`) and — in two_pass — runs
    the merged-state filter.
    """

    shards: int
    per_switch: PackingPlan      # identical replica placement
    entries_per_switch: int      # stream slice each replica ingests
    merge_bytes: int             # total state shipped to the master
    est_speedup: float           # vs a single sequential switch
    feasible: bool
    reason: str = ""


# master-side cost of folding one state byte, in units of per-entry
# stream work (the merge is vectorized, entries stream one at a time).
# This is the analytic prior; the engine's timed probe
# (`core.engine.calibrate_merge_cost`) measures it per algorithm on the
# device the streams live on.
_MERGE_BYTE_COST = 1.0 / 64.0

# algo -> measured merge cost per shipped state byte, in per-entry units
# (written by core.engine.calibrate_merge_cost, read by optimal_shards;
# a process-lifetime cache: the probe runs once per algorithm and signature)
MEASURED_MERGE_COSTS: dict[str, float] = {}


def plan_multi_switch(queries: dict[str, ResourceFootprint], m: int,
                      shards: int,
                      profile: SwitchProfile | None = None,
                      ndev: int = 1,
                      pass2: str | None = None) -> MultiSwitchPlan:
    """Model running `queries` over an m-entry stream on S switch replicas.

    Every replica must fit the full query set (same packing problem as a
    single switch — states are replicated, not split), so feasibility is
    `pack_queries` on one profile. The speedup model charges each replica
    ceil(m/S) entries of streaming work plus the master's fold over the
    S shipped states: T(S) = m/S + c·S·state_bytes. Diminishing returns
    appear once the merge term dominates — see `optimal_shards`.

    ``pass2`` adds the engine's merged-state filter to T(S):
    ``"master"`` / ``"mesh"`` charge the corresponding ``pass2_time``
    over ``ndev`` devices, ``"auto"`` charges the cheaper of the two,
    and ``None`` (default) models a pass-2-free workload (the
    historical behavior: GROUP BY-style all-absorbing pruners).
    """
    if shards < 1:
        raise ValueError("shards must be >= 1")
    plan = pack_queries(queries, profile)
    if not plan.feasible:
        return MultiSwitchPlan(shards, plan, 0, 0, 0.0, False, plan.reason)
    state_bytes = sum(fp.sram_bytes for fp in queries.values())
    entries = math.ceil(m / shards)
    merge_bytes = shards * state_bytes
    t_parallel = entries + _MERGE_BYTE_COST * merge_bytes
    if pass2 is not None:
        placement = (optimal_pass2(m, ndev, merge_bytes)
                     if pass2 == "auto" else pass2)
        t_parallel += pass2_time(m, ndev, merge_bytes, placement)
    return MultiSwitchPlan(
        shards=shards, per_switch=plan, entries_per_switch=entries,
        merge_bytes=merge_bytes,
        est_speedup=m / t_parallel, feasible=True)


# fixed cost of the resident pass-2 path, in per-entry stream-work units:
# the all-gather and every device folding the merged state are a constant
# dispatch and collective overhead that the per-entry terms do not
# capture. A model prior of 2^18 entries, not a measurement of this
# package; it only matters for mesh pass 2 over more than one position,
# and one H100 gives a mesh of one card (PERF.md).
RESIDENT_OVERHEAD_ENTRIES = float(1 << 18)


def pass2_time(m: int, ndev: int, state_bytes: int, placement: str,
               apply_entry_cost: float = 1.0,
               broadcast_byte_cost: float | None = None,
               resident_overhead: float | None = None) -> float:
    """Pass-2 term of T(S), in per-entry stream-work units.

    ``"master"``: the merged-state filter runs where the states were
    gathered — the master streams all m entries through it: m·f.

    ``"mesh"``: the merged state (state_bytes ≈ S·per-lane bytes) is
    broadcast to all D devices — state_bytes·D wire work at the same
    per-byte cost c as the pass-1 state shipping — each device filters
    only its resident m/D entries, and the fused collective + replicated
    fold cost a fixed ``resident_overhead``:
    state_bytes·D·c + (m/D)·f + overhead.

    f (``apply_entry_cost``) is the per-entry filter cost relative to
    one entry of pass-1 streaming; the scan-free applies are cheaper
    per entry than the scan body, so 1.0 is a conservative default.
    """
    if broadcast_byte_cost is None:
        broadcast_byte_cost = _MERGE_BYTE_COST
    if resident_overhead is None:
        resident_overhead = RESIDENT_OVERHEAD_ENTRIES
    if placement == "master":
        return m * apply_entry_cost
    if placement == "mesh":
        return (state_bytes * ndev * broadcast_byte_cost
                + (m / ndev) * apply_entry_cost
                + resident_overhead)
    raise ValueError(f"placement must be 'master' or 'mesh', "
                     f"got {placement!r}")


def optimal_pass2(m: int, ndev: int, state_bytes: int,
                  apply_entry_cost: float = 1.0,
                  broadcast_byte_cost: float | None = None,
                  resident_overhead: float | None = None) -> str:
    """Pick the pass-2 placement: master-apply m·f vs broadcast
    state_bytes·D + (m/D)·f + fixed resident overhead.

    With one device there is nothing to spread — master. Otherwise the
    resident apply wins when the (D-1)/D of the stream it keeps off the
    master outweighs both the merged-state re-broadcast and the fixed
    collective overhead — which flips the choice back to master for
    short streams. Used by ``engine_prune(pass2="auto")`` and the
    tuner's mesh incumbent.
    """
    if ndev <= 1:
        return "master"
    args = (apply_entry_cost, broadcast_byte_cost, resident_overhead)
    return ("mesh" if pass2_time(m, ndev, state_bytes, "mesh", *args)
            < pass2_time(m, ndev, state_bytes, "master", *args)
            else "master")


# ------------------------------------------------- multi-query admission
@dataclasses.dataclass(frozen=True)
class QueryBatchPlan:
    """Admission plan for Q concurrent queries against one device budget.

    The §8 resource constraint as an *enforcer*: every query in a wave
    keeps its (padded) switch state resident on every device while the
    batched engine runs, so a wave's total per-device bytes must fit
    ``device_budget_bytes``. Queries that don't fit together are split
    into sequential admission waves; a single query larger than the
    budget is admitted alone (and listed in ``oversized``) — serializing
    it further cannot shrink its state.

    Frozen with tuple fields so the plan is hashable (it rides along as
    static metadata on the batched engine's result pytree).
    """

    waves: tuple            # tuple[tuple[int, ...], ...] — query indices
    per_query_bytes: tuple  # int per query — resident state charge
    device_budget_bytes: int | None
    oversized: tuple = ()   # indices admitted alone despite exceeding it

    @property
    def num_waves(self) -> int:
        return len(self.waves)


def plan_query_batch(per_query_bytes, device_budget_bytes=None
                     ) -> QueryBatchPlan:
    """Pack Q query-state charges into admission waves under the budget.

    Order-preserving next-fit: queries are admitted in arrival order and
    a wave closes when the next query would overflow the budget, so each
    wave is a contiguous index run and concatenating wave results along
    Q preserves the caller's query order. ``device_budget_bytes=None``
    means no enforcement — one wave with every query.
    """
    per_query_bytes = tuple(int(b) for b in per_query_bytes)
    n = len(per_query_bytes)
    if device_budget_bytes is None:
        waves = (tuple(range(n)),) if n else ()
        return QueryBatchPlan(waves=waves, per_query_bytes=per_query_bytes,
                              device_budget_bytes=None)
    if device_budget_bytes <= 0:
        raise ValueError("device_budget_bytes must be positive or None")
    waves: list[tuple[int, ...]] = []
    cur: list[int] = []
    used = 0
    oversized: list[int] = []
    for i, b in enumerate(per_query_bytes):
        if b > device_budget_bytes:
            oversized.append(i)
        if cur and used + b > device_budget_bytes:
            waves.append(tuple(cur))
            cur, used = [], 0
        cur.append(i)
        used += b
    if cur:
        waves.append(tuple(cur))
    return QueryBatchPlan(waves=tuple(waves),
                          per_query_bytes=per_query_bytes,
                          device_budget_bytes=int(device_budget_bytes),
                          oversized=tuple(oversized))


def optimal_shards(m: int, state_bytes: int, max_shards: int = 4096,
                   merge_byte_cost: float | None = None,
                   algo: str | None = None) -> int:
    """argmin_S of T(S) = m/S + c·S·state_bytes: S* = sqrt(m / (c·bytes)).

    The per-byte merge cost c is resolved empirically when available:
    an explicit ``merge_byte_cost`` wins, then the measured constant for
    ``algo`` (recorded by ``core.engine.calibrate_merge_cost``), then
    the analytic ``_MERGE_BYTE_COST`` prior. Clamped to [1, max_shards];
    with zero state (pure filters) the model degenerates and every
    switch you can get helps.
    """
    if merge_byte_cost is None:
        merge_byte_cost = MEASURED_MERGE_COSTS.get(
            algo, _MERGE_BYTE_COST) if algo else _MERGE_BYTE_COST
    c = merge_byte_cost * state_bytes
    if c <= 0:
        return max_shards
    s = int(round(math.sqrt(m / c)))
    return max(1, min(s, max_shards))


# --------------------------------------------------- streaming merge period
# Marginal unpruned fraction added per micro-batch of merged-state
# staleness: with the cross-lane merge K batches old, lanes prune on a
# looser (older) global state and ship ~σ·b extra entries per batch of
# lag. Default is a conservative prior; chip_smoke.py's phase stream
# measures the slope on the card (PERF.md), and a planner change would
# take it from there.
DEFAULT_STALENESS_RATE = 2e-3
MAX_MERGE_INTERVAL = 64


def optimal_merge_interval(batch_entries: int, merge_cost_entries: float,
                           staleness_rate: float = DEFAULT_STALENESS_RATE,
                           ship_entry_cost: float = 1.0,
                           max_interval: int = MAX_MERGE_INTERVAL) -> int:
    """Merge period K* for the streaming engine's cross-lane merge.

    Per-batch cost of merging every K micro-batches, in per-entry units
    (the same currency as ``optimal_shards``'s T(S)):

        T(K) = merge_cost_entries / K                  (amortized merge)
             + staleness_rate · ship_entry_cost
               · batch_entries · (K - 1) / 2           (mean staleness lag)

    The first term is the fused all_gather + ``merge_states`` fold paid
    once per K batches; the second charges the extra unpruned entries a
    stale merged state lets through (average lag (K-1)/2 batches).
    Minimizing gives K* = sqrt(2·merge / (σ·c_ship·b)), clamped to
    [1, max_interval].
    """
    denom = staleness_rate * ship_entry_cost * max(batch_entries, 1)
    if denom <= 0:
        return max_interval
    k = math.sqrt(2.0 * max(merge_cost_entries, 0.0) / denom)
    return max(1, min(int(round(k)), max_interval))


# ------------------------------------------------ self-tuning plan search
# `tune` races a small candidate set of *mask-preserving* engine plans on a
# prefix of the entry stream and persists the winner in the plan cache
# (core.plancache). At a FIXED lane count S, `two_pass` with any
# `apply_block` chunking and `mesh` with either pass-2 placement over any
# device spread that divides S give BIT-IDENTICAL keep masks. S itself is
# semantic (it changes the lane states and so the mask), so the tuner takes
# S from the analytic model (optimal_shards over the measured merge cost)
# and races only the execution choices: chunk size, mode, pass-2 placement
# and the device spread. Plans change speed, never results.

TUNE_MODES = ("off", "cached", "race")
DEFAULT_PROBE_ENTRIES = 1 << 14
DEFAULT_EXIT_FACTOR = 1.5
DEFAULT_TIME_BUDGET_S = 2.0
# candidate apply_block values raced for the chunkable algorithms
CANDIDATE_BLOCKS = (1024, 4096)
# hard cap on the raced grid (incumbent included)
MAX_CANDIDATES = 12

# test seam: when set, used in place of wall-clock timing by every race
# that did not pass an explicit `measure` (tests inject recorded timings so
# race winners are deterministic)
MEASURE_HOOK = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """One executable engine configuration in the tuner's universe.

    All tuner plans run the two-pass family at the same lane count
    ``shards`` (>= 2: S=1 would degrade two_pass to the scan body, a
    *different mask family*), so any plan the tuner can select gives the
    analytic incumbent's keep mask. ``num_devices`` only matters for
    ``mode="mesh"`` and must divide ``shards``; a mesh plan runs on
    ``default_mesh(num_devices=num_devices)`` of the streams' device.
    """

    mode: str = "two_pass"        # "two_pass" | "mesh"
    shards: int = 8
    pass2: str = "master"         # mesh only: "master" | "mesh"
    apply_block: int | None = None
    num_devices: int = 1          # mesh only: lane spread

    def key(self) -> str:
        return (f"{self.mode}/s{self.shards}/p2-{self.pass2}"
                f"/b{self.apply_block or 0}/d{self.num_devices}")

    def to_dict(self) -> dict:
        return dict(mode=self.mode, shards=self.shards, pass2=self.pass2,
                    apply_block=self.apply_block,
                    num_devices=self.num_devices)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        """Validating deserializer: any malformed field raises ValueError
        so cache consumers can fall back to the analytic plan."""
        try:
            plan = cls(mode=d["mode"], shards=int(d["shards"]),
                       pass2=d.get("pass2", "master"),
                       apply_block=(None if d.get("apply_block") in
                                    (None, 0) else int(d["apply_block"])),
                       num_devices=int(d.get("num_devices", 1)))
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"malformed plan dict {d!r}: {e}") from e
        if plan.mode not in ("two_pass", "mesh"):
            raise ValueError(f"plan mode {plan.mode!r} outside the "
                             f"mask-preserving universe")
        if plan.pass2 not in ("master", "mesh"):
            raise ValueError(f"plan pass2 {plan.pass2!r} invalid")
        if plan.shards < 2:
            raise ValueError("tuned plans need shards >= 2 (S=1 changes "
                             "the mask family)")
        if plan.apply_block is not None and plan.apply_block < 1:
            raise ValueError("apply_block must be positive or None")
        if plan.num_devices < 1 or plan.shards % plan.num_devices:
            raise ValueError(f"num_devices={plan.num_devices} must "
                             f"divide shards={plan.shards}")
        return plan


@dataclasses.dataclass
class TuneResult:
    """What `tune` / `resolve_plan` decided and how.

    source: "cache" (hit: the race short-circuited), "race" (raced now,
    winner persisted when a cache is in play), or "analytic" (no race:
    tune="cached" miss, or a stream too short to race).
    timings: plan.key() -> probe microseconds for every candidate actually
    measured (incumbent first).
    """

    plan: Plan
    source: str
    key: str | None = None
    timings: dict = dataclasses.field(default_factory=dict)
    incumbent_us: float | None = None
    best_us: float | None = None
    race_wall_s: float = 0.0
    report: object | None = None  # repro_torch.obs.ExecReport (None if off)

    @property
    def speedup_x(self) -> float:
        """Raced winner vs analytic incumbent, from the race's own timings
        (>= 1.0 by construction: the incumbent is in the race)."""
        if not self.incumbent_us or not self.best_us:
            return 1.0
        return self.incumbent_us / self.best_us


def _streams(streams) -> tuple:
    """The streams as the engine takes them: Nones dropped, 64-bit columns
    narrowed as ``jnp.asarray`` narrows them for the JAX package."""
    return tuple(as_x32(s) for s in streams if s is not None)


def analytic_plan(algo: str, streams, params: dict | None = None, *,
                  shards: int | None = None,
                  max_devices: int | None = None) -> Plan:
    """The incumbent: what the analytic formulas pick today.

    S from ``optimal_shards`` over the measured merge cost
    (``calibrate_merge_cost``: the incumbent is already calibrated, the
    race challenges what the formulas do not measure), clamped to [2, m];
    mesh when more than one position can host the lanes (the largest
    divisor of S up to ``max_devices``), with ``optimal_pass2`` choosing
    the pass-2 placement; the chunkable algorithms get the engine's default
    apply block when a lane is longer than it.
    """
    from . import engine as _engine  # lazy: engine imports planner
    from .mesh import mesh_spreads

    params = dict(params or {})
    streams = _streams(streams)
    m = int(streams[0].shape[0])
    c, state_bytes = _engine.calibrate_merge_cost(algo, streams, params)
    s = shards if shards is not None else optimal_shards(
        m, state_bytes, merge_byte_cost=c)
    s = max(2, min(int(s), m))
    ndev = (mesh_spreads(s, max_devices, streams[0].device) or [1])[0]
    mode = "mesh" if ndev > 1 else "two_pass"
    pass2 = "master"
    if mode == "mesh":
        pass2 = optimal_pass2(m, ndev, s * state_bytes)
    block = None
    if _engine._SPECS[algo].chunkable \
            and -(-m // s) > _engine.DEFAULT_MESH_APPLY_BLOCK:
        block = _engine.DEFAULT_MESH_APPLY_BLOCK
    return Plan(mode=mode, shards=s, pass2=pass2, apply_block=block,
                num_devices=ndev if mode == "mesh" else 1)


def candidate_plans(algo: str, streams, params: dict | None = None, *,
                    incumbent: Plan | None = None,
                    max_devices: int | None = None,
                    max_candidates: int = MAX_CANDIDATES) -> list:
    """The raced grid: incumbent first, then mask-preserving variants.

    mode x pass2 x chunk x device spread at the incumbent's S: for each
    pass-2 chunk (whole, then each of CANDIDATE_BLOCKS shorter than a
    lane), two_pass, then the two widest spreads that divide S and that
    ``default_mesh`` can build (``mesh.mesh_spreads``), each with the
    resident and the master pass 2. Every plan here gives the incumbent's
    keep mask.
    """
    from . import engine as _engine
    from .mesh import mesh_spreads

    params = dict(params or {})
    streams = _streams(streams)
    if incumbent is None:
        incumbent = analytic_plan(algo, streams, params,
                                  max_devices=max_devices)
    s = incumbent.shards
    n_per = -(-int(streams[0].shape[0]) // s)
    chunkable = _engine._SPECS[algo].chunkable
    blocks = [None] + [b for b in CANDIDATE_BLOCKS
                       if chunkable and b < n_per]
    devs = mesh_spreads(s, max_devices, streams[0].device)[:2]
    plans = [incumbent]
    for block in blocks:
        plans.append(Plan(mode="two_pass", shards=s, apply_block=block))
        for d in devs:
            for p2 in ("mesh", "master"):
                plans.append(Plan(mode="mesh", shards=s, pass2=p2,
                                  apply_block=block, num_devices=d))
    out, seen = [], set()
    for p in plans:
        if p.key() not in seen:
            seen.add(p.key())
            out.append(p)
    return out[:max_candidates]


def _time_plan_us(thunk) -> float:
    """Default race measurement: one warm-up run, then the best of 2."""
    thunk()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        thunk()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def _cached_plan(cache, key: str, m: int, *, warn_long: bool
                 ) -> Plan | None:
    """The usable cached plan under ``key``, or None. A malformed entry
    warns; so does one with more shards than the stream has entries when
    ``warn_long`` (the race warns, the cached mode passes over it)."""
    entry = cache.get(key)
    if entry is None:
        return None
    try:
        plan = Plan.from_dict(entry["plan"])
        if plan.shards > m and warn_long:
            raise ValueError(f"cached shards={plan.shards} exceed stream "
                             f"length {m}")
    except ValueError as e:
        _obslog.warn(f"ignoring unusable cached plan for {key!r}: {e}",
                     logger="core.planner", stacklevel=3)
        return None
    return plan if plan.shards <= m else None


def tune(algo: str, streams, params: dict | None = None, *,
         probe_entries: int = DEFAULT_PROBE_ENTRIES,
         exit_factor: float = DEFAULT_EXIT_FACTOR,
         time_budget_s: float = DEFAULT_TIME_BUDGET_S,
         cache=None, use_cache: bool = True,
         measure=None, max_devices: int | None = None,
         obs: str | None = None) -> TuneResult:
    """Race candidate plans on a prefix of the streams; keep the winner.

    The analytic incumbent runs first, then each candidate in grid order;
    racing stops once a candidate beats the incumbent by >= ``exit_factor``
    or the ``time_budget_s`` wall budget is spent (the incumbent's own
    probe is always measured, so `speedup_x` is defined and >= 1.0). The
    winner is persisted to the plan cache keyed by (algo, query shape,
    m-bucket, distribution fingerprint, device); a later call with the
    same key skips the race.

    Each candidate's probe runs ``execute_plan`` on the first
    ``probe_entries`` entries (at least S) and synchronises the streams'
    device before the clock is read, so the race times the kernels, not
    their launches. ``measure(plan, thunk) -> us`` overrides the clock
    (tests inject recorded timings); ``cache=None`` uses the default cache
    file, ``use_cache=False`` disables lookup and persistence.

    Telemetry (``obs``): the ``planner.tune`` report counts
    ``plan_cache_hit`` / ``plan_cache_miss`` and ``tune_candidates``. The
    JAX package also counts ``compile_count`` once a candidate, since each
    compiles an XLA executable; nothing compiles here, so the port does
    not count it.
    """
    from . import engine as _engine
    from . import plancache as _pc

    params = dict(params or {})
    streams = _streams(streams)
    if obsreport._compiling():
        raise ValueError(
            "planner.tune races wall-clock time and needs concrete "
            "streams — call it outside jit")
    rec = obsreport.recorder("planner.tune", obs)
    m = int(streams[0].shape[0])
    if rec.active:
        rec.annotate(algo=algo, m=m)
    key = None
    if use_cache:
        cache = cache if cache is not None else _pc.PlanCache()
        key = _pc.cache_key(algo, streams, params)
        plan = _cached_plan(cache, key, m, warn_long=True)
        if plan is not None:
            result = TuneResult(plan=plan, source="cache", key=key)
            if rec.active:
                rec.count("plan_cache_hit", 1)
                rec.annotate(source="cache", plan=plan.key())
                result.report = rec.finish()
            return result
        if rec.active:
            rec.count("plan_cache_miss", 1)

    incumbent = analytic_plan(algo, streams, params,
                              max_devices=max_devices)
    if m < 4:
        result = TuneResult(plan=incumbent, source="analytic", key=key)
        if rec.active:
            rec.annotate(source="analytic", plan=incumbent.key())
            result.report = rec.finish()
        return result
    plans = candidate_plans(algo, streams, params, incumbent=incumbent,
                            max_devices=max_devices)
    probe_m = max(min(m, probe_entries), incumbent.shards)
    probe = tuple(s[:probe_m] for s in streams)
    device = streams[0].device
    if measure is None:
        measure = MEASURE_HOOK
    timings: dict = {}
    t0 = time.perf_counter()
    best_plan, best_us, incumbent_us = incumbent, None, None
    with rec.span("tune_race", candidates=len(plans),
                  probe_entries=probe_m):
        for i, plan in enumerate(plans):
            def thunk(plan=plan):
                _engine.execute_plan(algo, *probe, plan=plan, obs="off",
                                     **params)
                _engine._sync(device)

            with rec.span(f"candidate:{plan.key()}"):
                us = (float(measure(plan, thunk)) if measure is not None
                      else _time_plan_us(thunk))
            timings[plan.key()] = us
            if rec.active:
                rec.count("tune_candidates", 1)
            if i == 0:
                incumbent_us = best_us = us
            elif us < best_us:
                best_us, best_plan = us, plan
            if i > 0 and us * exit_factor <= incumbent_us:
                break  # exit gate: beat the incumbent by >= the factor
            if time.perf_counter() - t0 >= time_budget_s:
                break
    wall = time.perf_counter() - t0
    result = TuneResult(plan=best_plan, source="race", key=key,
                        timings=timings, incumbent_us=incumbent_us,
                        best_us=best_us, race_wall_s=wall)
    if use_cache:
        cache.put(key, best_plan.to_dict(), algo=algo, m=m,
                  probe_entries=probe_m, incumbent=incumbent.key(),
                  raced=len(timings), speedup_x=round(result.speedup_x, 3))
    if rec.active:
        rec.annotate(source="race", plan=best_plan.key(),
                     speedup_x=round(result.speedup_x, 3))
        result.report = rec.finish()
    return result


def resolve_plan(algo: str, streams, params: dict | None = None,
                 tune_mode: str = "race", cache=None,
                 obs: str | None = None, **tune_kwargs) -> TuneResult:
    """The engine's tune= knob, as a planner entry point.

    ``"cached"``: cache hit -> cached plan; miss -> analytic incumbent
    (never races, never writes). ``"race"``: cache hit -> cached plan;
    miss -> race now and persist the winner. ``"off"`` is rejected here
    (the engine handles it by not calling us).
    """
    if tune_mode not in ("cached", "race"):
        raise ValueError(
            f"tune must be one of {TUNE_MODES}, got {tune_mode!r}")
    from . import plancache as _pc

    params = dict(params or {})
    streams = _streams(streams)
    if tune_mode == "race":
        return tune(algo, streams, params, cache=cache, obs=obs,
                    **tune_kwargs)
    rec = obsreport.recorder("planner.tune", obs)
    cache = cache if cache is not None else _pc.PlanCache()
    key = _pc.cache_key(algo, streams, params)
    plan = _cached_plan(cache, key, int(streams[0].shape[0]),
                        warn_long=False)
    if plan is not None:
        result = TuneResult(plan=plan, source="cache", key=key)
        if rec.active:
            rec.count("plan_cache_hit", 1)
            rec.annotate(algo=algo, source="cache", plan=plan.key())
            result.report = rec.finish()
        return result
    result = TuneResult(plan=analytic_plan(algo, streams, params),
                        source="analytic", key=key)
    if rec.active:
        rec.count("plan_cache_miss", 1)
        rec.annotate(algo=algo, source="analytic", plan=result.plan.key())
        result.report = rec.finish()
    return result


def rule_count(algo: str, **p) -> int:
    """Control-plane rules per query: 10-20 (paper §7.1)."""
    base = {"distinct_lru": 12, "distinct_fifo": 12, "topn_det": 14,
            "topn_rand": 12, "groupby": 13, "join_bf": 11, "having": 13,
            "skyline_sum": 16, "skyline_aph": 20, "filter": 10}
    return base.get(algo, 15)
