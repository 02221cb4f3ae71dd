"""TOP-N pruning (paper §4.3 Ex. 3 deterministic, §5 Ex. 7 randomized).

Deterministic: an exponential threshold ladder t_i = 2^i * t0, t0 the
minimum of the first N entries; once >= N entries at or above t_i are
seen, the prune threshold advances to t_i. Never prunes a true top-N entry.
The scan runs on the ``topn_det_pass1`` kernel with one lane.

Randomized: a d x w matrix; each entry is hashed (by its stream index) to a
row that keeps a rolling descending top-w; an entry smaller than all w
cached values of its row is pruned. Succeeds (no top-N entry pruned) with
probability at least 1-δ for w per Theorem 2; Theorem 3 bounds the
forwarded count. The scan runs on the pass-1 kernel with one lane and
blocks of one entry, which is the per-entry semantics of the JAX package's
``lax.scan``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np
import torch

from ..constants import NEG
from ..device import resolve_device
from .pruning import PruneResult


@dataclasses.dataclass
class TopNRandState:
    vals: torch.Tensor  # f32[d, w] per-row descending rolling top-w


def topn_rand_init(d: int, w: int, device) -> TopNRandState:
    return TopNRandState(vals=torch.full((d, w), float(NEG),
                                         dtype=torch.float32, device=device))


def topn_rand_prune(values: torch.Tensor, *, d: int, w: int, seed: int = 0,
                    state: TopNRandState | None = None,
                    index_offset=0) -> PruneResult:
    """Randomized TOP-N matrix (Fig. 2) over f32[m] values (larger = better).

    state/index_offset resume a prior scan: the row hashes the stream
    index, so a resumed call passes the count of entries the carried state
    has consumed as ``index_offset`` (taken mod 2^32, as the reference's
    uint32 add wraps). The carried state is not changed."""
    from ..kernels.parallel import topn_shard_states_kernel

    carried = None if state is None else state.vals.to(
        torch.float32).reshape(1, d, w).clone()
    keep, states = topn_shard_states_kernel(
        values.to(torch.float32).contiguous(), d=d, w=w, shards=1, block=1,
        seed=seed, family="engine", state=carried,
        index_offset=int(index_offset))
    return PruneResult(keep=keep, state=TopNRandState(states[0]))


@dataclasses.dataclass
class TopNDetState:
    t0: torch.Tensor         # f32: min of the first N entries (POS: none yet)
    counts: torch.Tensor     # int32[w]: entries >= t0 * 2^i seen so far
    seen: torch.Tensor       # int32: entries processed
    cur_level: torch.Tensor  # int32: highest i with counts[i] >= N (-1: none)


def topn_det_init(w: int = 4, device=None) -> TopNDetState:
    from ..kernels.topn_det_scan import init_state

    t0, counts, seen, cur = init_state(1, w, resolve_device(device))
    return TopNDetState(t0=t0[0], counts=counts[0], seen=seen[0],
                        cur_level=cur[0])


def topn_det_prune(values: torch.Tensor, *, N: int, w: int = 4,
                   state: TopNDetState | None = None) -> PruneResult:
    """Deterministic threshold-ladder TOP-N (Ex. 3) over f32[m] values.

    During the first N entries nothing is pruned; afterwards an entry below
    t0 * 2^cur_level is. A superset of the true top-N survives. ``state``
    resumes a prior scan (the warm-up counter rides in it, so a resumed
    batch never warms again); the carried state is not changed.
    """
    from ..kernels.topn_det_scan import topn_det_pass1_kernel

    carried = None if state is None else tuple(
        t.reshape((1,) + tuple(t.shape)).to(dt).clone() for t, dt in (
            (state.t0, torch.float32), (state.counts, torch.int32),
            (state.seen, torch.int32), (state.cur_level, torch.int32)))
    keep, (t0, counts, seen, cur) = topn_det_pass1_kernel(
        values.to(torch.float32).contiguous(), N=N, w=w, state=carried)
    return PruneResult(keep=keep, state=TopNDetState(t0[0], counts[0],
                                                     seen[0], cur[0]))


def thm2_w(d: int, N: int, delta: float) -> int:
    """Theorem 2: matrix columns for success probability 1-δ given d rows."""
    num = 1.3 * math.log(d / delta)
    den = math.log((d / (N * math.e)) * math.log(d / delta))
    if den <= 0:
        raise ValueError("d too small: need d > N*e/ln(d/δ) (Thm 2 precondition)")
    return math.ceil(num / den)


def thm2_opt_d(N: int, delta: float) -> int:
    """Space-optimal d = δ·e^{W(N·e²/δ)} (§5 'Optimizing the Space')."""
    z = N * math.e**2 / delta
    wv = math.log(z) - math.log(max(math.log(z), 1e-9))
    for _ in range(50):
        ew = math.exp(wv)
        wv -= (wv * ew - z) / (ew * (wv + 1))
    return max(1, round(delta * math.exp(wv)))


def thm3_forwarded_bound(m: int, d: int, w: int) -> float:
    """Theorem 3: expected forwarded count <= w*d*ln(m*e/(w*d))."""
    return w * d * math.log(m * math.e / (w * d))


def opt_keep_topn(values, N: int) -> torch.Tensor:
    """OPT forwards an entry iff it is among the top-N of the prefix so far
    (a host-side oracle; returns a CPU bool tensor)."""
    v = torch.as_tensor(values).cpu().numpy().astype(np.float64)
    out = np.zeros(v.shape[0], bool)
    heap: list = []
    for i, x in enumerate(v.tolist()):
        if len(heap) < N:
            heapq.heappush(heap, x)
            out[i] = True
        elif x > heap[0]:
            heapq.heapreplace(heap, x)
            out[i] = True
    return torch.from_numpy(out)


def master_complete_topn(values: torch.Tensor, keep: torch.Tensor, N: int):
    """Exact top-N among forwarded entries (master side): (values, indices).

    The order is ``lax.top_k``'s: XLA's total order of floats, in which a
    NaN with its sign set lies below -inf, -0 below +0 and +NaN on top, and
    ties go to the lower index. A stable descending sort of the bits' total-
    order int32 image (the low 31 bits flipped where the sign is set) gives
    both.
    """
    masked = torch.where(keep, values.to(torch.float32),
                         torch.tensor(float(NEG), device=values.device))
    bits = masked.view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(order, descending=True, stable=True).indices[:N]
    return masked[idx], idx
