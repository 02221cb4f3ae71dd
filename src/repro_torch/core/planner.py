"""The analytic query planner and multi-query packing (paper §3, §6, Table 2).

The planner computes a query's switch resource footprint from Table 2's
cost model, packs concurrent queries onto one pipeline (splitting per-stage
ALUs and SRAM, reusing stages across resource-orthogonal algorithms),
models S switch replicas and a merging master (``plan_multi_switch``,
``optimal_shards``: the lane count behind ``engine_prune(shards="auto")``),
places pass 2, admits query batches under a device budget and picks the
streaming merge period. Pure Python: nothing here touches a tensor.

The self-tuning plan search of the JAX package (``Plan``, ``tune``,
``resolve_plan``) is not ported yet (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
import math


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
# package; it only matters for mesh pass 2 (ROADMAP Queue 1 item 7), which
# is not ported yet, and is to be measured on the cards when it is.
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
    short streams. Used by ``engine_prune(pass2="auto")`` once mesh mode
    is ported.
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


def rule_count(algo: str, **p) -> int:
    """Control-plane rules per query: 10-20 (paper §7.1)."""
    base = {"distinct_lru": 12, "distinct_fifo": 12, "topn_det": 14,
            "topn_rand": 12, "groupby": 13, "join_bf": 11, "having": 13,
            "skyline_sum": 16, "skyline_aph": 20, "filter": 10}
    return base.get(algo, 15)
