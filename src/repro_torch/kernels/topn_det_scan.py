"""Deterministic TOP-N pass 1 (paper Ex. 3): the per-lane threshold-ladder
scan kernel and its plain version.

``topn_det_pass1_kernel`` replaces the ``lax.scan`` of the JAX package's
``core.topn.topn_det_prune`` (``core/topn.py:112-137``), which has no Pallas
kernel; it carries the engine's ``scan``, ``sharded`` and ``two_pass``
modes. S lanes, one per contiguous shard, each with a fresh ladder
(t0 = POS, counts = 0, seen = 0) or a carried one (``state``: the
streaming fold, where an entry is warm while seen + j < N). Per entry
x_j of a fresh lane:

- t0_j is the running minimum of the first min(j + 1, N) entries and POS;
- counts_j[i] counts the entries k <= j with x_k >= t0_k * 2^i;
- cur_j is the highest i with counts_j[i] >= N (-1: none), and the entry is
  kept while warm (j < N) or when x_j >= t0_j * 2^cur_j.

So the ladder is a prefix computation: a ``cummin`` and a ``cumsum`` over
[n, w]. Every step is an exact f32 minimum (NaN-propagating, as
``jnp.minimum``), an exact multiply by a power of two, a compare or an
integer count, all with f32 subnormals flushed as XLA flushes them (A25),
so the plain version below is bit-identical to the scan, and
so is the CUDA kernel (``csrc/topn_det.cu``): a chunked scan whose grid is
every chunk of 4096 entries of every lane (the warm chunks' minima, a
min-scan over them, per-level chunk counts, a sum-scan over them, and a
replay of each chunk from its entering counts). A CUDA tensor launches the
kernel; a CPU tensor runs the plain version.
"""
from __future__ import annotations

import torch

from ..constants import NEG, POS
from .common import (I32, P, CudaKernel, check_cuda, cummin_f32,
                     flush_subnormals, ptr, workspace)

TOPN_DET_PASS1 = CudaKernel("topn_det_pass1", [P, P, P, P, P, P, I32, I32,
                                               I32, I32, I32, P])
MAX_W = 32  # levels the kernel carries (csrc/topn_det.cu: TOPN_DET_MAX_W)


def pow2(w: int, device) -> torch.Tensor:
    """f32[w]: 2^0 .. 2^(w-1), exact."""
    return torch.tensor([2.0 ** i for i in range(w)], dtype=torch.float32,
                        device=device)


def check_levels(w: int) -> None:
    if not 1 <= w <= MAX_W:
        raise ValueError(f"the ladder takes 1 <= w <= {MAX_W} levels, got {w}")


def init_state(shards: int, w: int, device):
    """Fresh ladders: (t0 f32[S] = POS, counts int32[S, w], seen int32[S],
    cur_level int32[S] = -1)."""
    return (torch.full((shards,), float(POS), dtype=torch.float32,
                       device=device),
            torch.zeros((shards, w), dtype=torch.int32, device=device),
            torch.zeros((shards,), dtype=torch.int32, device=device),
            torch.full((shards,), -1, dtype=torch.int32, device=device))


def topn_det_pass1_plain(x: torch.Tensor, *, N: int, w: int,
                         state: tuple | None = None):
    """Plain pass 1 over lanes [S, n]: (keep bool[S, n], (t0, counts, seen,
    cur_level) of each lane). ``state`` resumes each lane's ladder from a
    carried (t0 [S], counts [S, w], seen [S], cur_level [S]), which takes
    the final one in place: an entry is warm while seen + j < N, t0's
    minimum starts from the carried t0 and the counts from the carried
    ones (int32, which wrap as the reference's do)."""
    check_levels(w)
    S, n = x.shape
    dev = x.device
    if state is None:
        t_in, c_in, s_in, cur_in = init_state(S, w, dev)
    else:
        t_in, c_in, s_in, cur_in = (t.reshape((S,) + t.shape[1:])
                                    for t in state)
    if n == 0:
        out = tuple(t.clone() for t in (t_in, c_in, s_in, cur_in))
    else:
        # every use of a value is a minimum or a compare, which XLA
        # computes with f32 subnormals flushed (A25)
        x = flush_subnormals(x.to(torch.float32))
        warm = (s_in.to(torch.int64)[:, None]
                + torch.arange(n, device=dev)) < N                  # [S, n]
        pos = torch.tensor(float(POS), dtype=torch.float32, device=dev)
        cand = torch.where(warm, x, pos)
        t0 = cummin_f32(torch.cat([t_in[:, None], cand], 1), 1)[:, 1:]
        p2 = pow2(w, dev)
        ge = x[..., None] >= t0[..., None] * p2                  # [S, n, w]
        counts = (torch.cumsum(ge, 1, dtype=torch.int64)
                  + c_in.to(torch.int64)[:, None])
        counts = ((counts + (1 << 31)) % (1 << 32) - (1 << 31)).to(
            torch.int32)
        levels = torch.arange(w, dtype=torch.int32, device=dev)
        cur = torch.where(counts >= N, levels, -1).amax(-1)     # [S, n]
        thr = torch.where(cur >= 0, t0 * p2[cur.clamp(min=0)],
                          torch.tensor(float(NEG), device=dev))
        keep = warm | (x >= thr)
        seen = ((s_in.to(torch.int64) + n + (1 << 31)) % (1 << 32)
                - (1 << 31)).to(torch.int32)
        out = (t0[:, -1].contiguous(), counts[:, -1].contiguous(), seen,
               cur[:, -1].to(torch.int32).contiguous())
    if state is not None:
        out = tuple(c.copy_(o.reshape(c.shape)).reshape(o.shape)
                    for c, o in zip(state, out))
    if n == 0:
        return torch.zeros((S, 0), dtype=torch.bool, device=dev), out
    return keep, out


def topn_det_pass1_kernel(values: torch.Tensor, *, N: int, w: int,
                          shards: int = 1, state: tuple | None = None):
    """Pass 1 of S ladders over f32[m] values: (keep bool[m], (t0 f32[S],
    counts int32[S, w], seen int32[S], cur_level int32[S])). Lane s owns
    the entries [s * m/S, (s+1) * m/S). ``state``, such a stacked tuple,
    resumes the ladders: read at entry and written back in place (the
    kernel copies it into its workspace before any launch writes it)."""
    m = values.shape[0]
    if shards < 1 or m % shards:
        raise ValueError(f"stream length {m} is not a multiple of "
                         f"shards={shards}")
    check_levels(w)
    n = m // shards
    if state is not None:
        _check_state(state, shards, w, values.device)
    if not values.is_cuda:
        keep, st = topn_det_pass1_plain(values.reshape(shards, n), N=N, w=w,
                                        state=state)
        return keep.reshape(m), st
    check_cuda("values", values, torch.float32)
    dev = values.device
    keep = torch.empty(m, dtype=torch.bool, device=dev)
    if not m:
        return keep, (init_state(shards, w, dev) if state is None
                      else state)
    # the kernel writes every lane's (t0, counts, seen, cur_level)
    st = state if state is not None else (
        torch.empty(shards, dtype=torch.float32, device=dev),
        torch.empty((shards, w), dtype=torch.int32, device=dev),
        torch.empty(shards, dtype=torch.int32, device=dev),
        torch.empty(shards, dtype=torch.int32, device=dev))
    work = workspace(dev, "topn_det_pass1_workspace", shards, n, N, w)
    TOPN_DET_PASS1.launch(dev, ptr(values), ptr(keep), *(ptr(s) for s in st),
                          shards, n, N, w, int(state is not None), ptr(work))
    return keep, st


def _check_state(state: tuple, shards: int, w: int,
                 device: torch.device) -> None:
    """A carried ladder state must be (t0 f32[S], counts int32[S, w], seen
    int32[S], cur_level int32[S]), contiguous, on the values' device."""
    want = ((torch.float32, (shards,)), (torch.int32, (shards, w)),
            (torch.int32, (shards,)), (torch.int32, (shards,)))
    if len(state) != 4 or any(
            t.dtype != dt or tuple(t.shape) != sh or t.device != device
            or not t.is_contiguous() for t, (dt, sh) in zip(state, want)):
        raise ValueError(f"a carried ladder state is (t0 f32[{shards}], "
                         f"counts int32[{shards}, {w}], seen int32[{shards}], "
                         f"cur_level int32[{shards}]) on {device}")
