"""SKYLINE pruning (paper §4.4 Ex. 6): w stored points + monotone projection.

The switch stores w points sorted descending by a scalar score h(x) that is
monotone in every dimension, so a point that dominates x scores at least
h(x). An entry is forwarded iff no stored point dominates it (at least one
strict inequality, so exact duplicates are never pruned); it is then
sorted-inserted when it beats the last stored score. The master computes
the exact skyline of the forwarded points.

Scores: SUM (the D coordinates added left to right) and APH, a sum of
piecewise-linear log2 terms ``e + (v/2^e - 1)`` for v >= 1 and -16 below.
The port takes ``e`` from the exponent bits and ``2^e`` exactly, where the
JAX package calls ``floor(log2(.))`` and ``exp2``; the two agree bit for
bit on the value ranges of the benchmark tables (below 2000, and the
gamma law of ``ad_revenue``) and within 2 ulp elsewhere (ROADMAP Queue 3).
A coordinate of +inf scores NaN, as ``inf / exp2(inf)`` does there.

``form`` picks the association of the APH term: ``"engine"`` is
``e + (m - 1)`` as the engine's ``score_aph`` computes it, ``"kernel"`` is
``(e + m) - 1`` as the Pallas kernel does (m = v / 2^e in [1, 2)).

The scan runs on the pass-1 CUDA kernel with one lane and blocks of one
entry, which is the per-entry semantics of the JAX package's ``lax.scan``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..constants import NEG
from ..device import resolve_device
from .pruning import PruneResult

SCORES = ("sum", "aph")
FORMS = ("engine", "kernel")


def _sum_left_to_right(t: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis as XLA's reduce sums it: left to right from an
    init of +0, so that a sum of -0s is +0, every add flushing f32
    subnormals (A25; a reduce of one element is the element itself)."""
    from ..kernels.common import ftz_add

    acc = t[..., 0]
    for j in range(1, t.shape[-1]):
        acc = ftz_add(acc, t[..., j])
    return acc + 0.0 if t.shape[-1] > 1 else acc


def score_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ x_j over the last axis, in f32, left to right."""
    return _sum_left_to_right(x.to(torch.float32))


def aph_terms(x: torch.Tensor, form: str = "engine") -> torch.Tensor:
    """The per-coordinate piecewise-linear log2 of APH, exactly."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    v = x.to(torch.float32)
    bits = torch.clamp_min(v, 1.0).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32)
    mant = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    lg = e + (mant - 1.0) if form == "engine" else (e + mant) - 1.0
    # +inf: XLA's floor(log2(inf)) + inf / exp2(inf) - 1 is NaN
    lg = torch.where(v == float("inf"), float("nan"), lg)
    return torch.where(v >= 1.0, lg, torch.full_like(lg, -16.0))


def score_aph(x: torch.Tensor, form: str = "engine") -> torch.Tensor:
    """Approximate Product Heuristic: Σ log2~(x_j), left to right."""
    return _sum_left_to_right(aph_terms(x, form))


def score(x: torch.Tensor, kind: str, form: str = "engine") -> torch.Tensor:
    """The score of each row of ``x`` [..., D] under ``kind`` ("sum"/"aph")."""
    if kind == "sum":
        return score_sum(x)
    if kind == "aph":
        return score_aph(x, form)
    raise ValueError(f"score must be one of {SCORES}, got {kind!r}")


@dataclasses.dataclass
class SkylineState:
    points: torch.Tensor  # f32[w, D] sorted descending by score
    scores: torch.Tensor  # f32[w]    (NEG = empty slot)


def skyline_init(w: int, D: int, device=None) -> SkylineState:
    """An empty store on ``device`` (None: the card)."""
    device = resolve_device(device)
    return SkylineState(
        points=torch.zeros((w, D), dtype=torch.float32, device=device),
        scores=torch.full((w,), float(NEG), dtype=torch.float32,
                          device=device))


def skyline_prune(points: torch.Tensor, *, w: int, score: str = "aph",
                  state: SkylineState | None = None) -> PruneResult:
    """Stream points (f32/int [m, D], maximising every dimension) through
    w stages: keep bool[m] and the final store. ``state`` resumes a prior
    scan from its store; the carried state is not changed."""
    from ..kernels.parallel import skyline_shard_states_kernel

    carried = None if state is None else tuple(
        t.to(torch.float32).reshape((1,) + tuple(t.shape)).clone()
        for t in (state.points, state.scores))
    keep, pts, scs = skyline_shard_states_kernel(
        points.to(torch.float32).contiguous(), w=w, shards=1, block=1,
        score=score, form="engine", state=carried)
    return PruneResult(keep=keep, state=SkylineState(pts[0], scs[0]))


def _dominated_by(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """bool[c, k]: p[i] dominates q[j] (>= everywhere, > somewhere)."""
    ge = (p[None] >= q[:, None]).all(-1)
    gt = (p[None] > q[:, None]).any(-1)
    return ge & gt


def _chunk(k: int, D: int) -> int:
    """Rows per chunk of the [c, k, D] comparisons: about 2^25 elements."""
    return max(1, (1 << 25) // max(1, k * D))


def master_complete_skyline(points: torch.Tensor,
                            keep: torch.Tensor) -> torch.Tensor:
    """Exact skyline over forwarded points, mapped back to original rows.

    Compares in float64, vectorised over chunks of survivors: O(k^2 D)
    work on the device, without a Python loop per survivor.
    """
    p = points.to(torch.float64)
    idx = torch.nonzero(keep).flatten()
    sub = p[idx]
    k = sub.shape[0]
    alive = torch.empty(k, dtype=torch.bool, device=p.device)
    c = _chunk(k, p.shape[-1])
    for j0 in range(0, k, c):
        alive[j0:j0 + c] = ~_dominated_by(sub[j0:j0 + c], sub).any(1)
    out = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    out[idx] = alive
    return out


def skyline_oracle(points: torch.Tensor) -> torch.Tensor:
    """True skyline membership mask."""
    points = torch.as_tensor(points)
    return master_complete_skyline(
        points, torch.ones(points.shape[0], dtype=torch.bool,
                           device=points.device))


def opt_keep_skyline(points: torch.Tensor) -> torch.Tensor:
    """OPT forwards a point iff no *previous* point dominates it."""
    p = torch.as_tensor(points).to(torch.float64)
    m = p.shape[0]
    out = torch.empty(m, dtype=torch.bool, device=p.device)
    c = _chunk(m, p.shape[-1])
    ar = torch.arange(m, device=p.device)
    for j0 in range(0, m, c):
        dom = _dominated_by(p[j0:j0 + c], p)
        earlier = ar[None] < ar[j0:j0 + c, None]
        out[j0:j0 + c] = ~(dom & earlier).any(1)
    return out
