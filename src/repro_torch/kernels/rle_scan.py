"""Deterministic TOP-N over RLE runs: the run-level kernel and its plain
version.

Port of ``src/repro/kernels/rle_scan.py``. Every entry of a run carries the
same value v, so the threshold ladder of ``core.topn.topn_det_prune`` has a
closed form per run (v, L) with entering state (t0, counts[w], seen):

    t0'   = seen < N ? min(t0, v) : t0
    ge[i] = v >= t0' * 2^i
    A     = max({i : counts[i] >= N and not ge[i]} ∪ {-1})
    C     = max({counts[i] : ge[i] and i > A} ∪ {-1})
    head  = clip(N - seen, 0, L)
    tstar = A < 0 ? 1 : (C >= 0 ? N - C : 2^30)

and within the run keep[t] = (t < head) | (t + 1 >= tstar)
(``ops.rle_expand_mask``). The state moves on by counts += L * ge,
seen += L, t0 = t0'. ge is not a prefix in i when t0' <= 0, so A and C are
computed from the whole vector. Pad runs are (POS, 0): POS never lowers t0
and L = 0 leaves counts and seen alone.

The sums are int32 with two's-complement wrap, as in the JAX package
(``seen``, the level counts, ``N - seen`` and ``N - C``): once the run
lengths sum past 2^31, ``seen`` wraps negative and later runs count as warm
again, so the warm runs need not be a prefix of the runs (ROADMAP Queue 3
A10). ``N`` is an int32, as JAX takes a Python int.

``rle_topn_det_kernel`` runs ``rle_topn_det_ref`` for a CPU tensor and
launches the CUDA kernel for a CUDA tensor. The kernel replaces
``rle_topn_det_kernel`` of the JAX package (``kernels/rle_scan.py:98``),
whose grid walks the runs in order, one block at a time. On the card that
order would leave one SM busy (the one-CTA form took 7.8 ms for 2^19 runs
on an H100), so ``csrc/topn_det.cu`` cuts the runs into chunks of 2048 and
runs the closed form's three prefix stages (seen, t0, the level counts) as
card-wide scans over the chunks, then replays every chunk from its entering
state, all in one cooperative launch with grid barriers between the steps.
Its uint32 sums read as int32 give the JAX package's bits, and every scan
operator is associative, so the chunking changes no bit. The runs are a few
MiB, so what bounds the kernel is latency (the grid barriers and the scans
of the chunk totals), and the call is bound by host time, which one launch
keeps lower than the seven launches of the same stages as separate kernels
(PERF.md gives both times). The one-CTA kernel stays as the C entry
``rle_topn_det_serial``, which no entry point launches: ``chip_smoke.py``
holds the chunked scan against it.

The plain version takes the closed form over all runs at once (``cumsum``
/ ``cummin``), with no loop over runs; both are bit-identical to the
Pallas kernel.
"""
from __future__ import annotations

import torch

from ..constants import POS
from .common import (I32, P, CudaKernel, check_cuda, cummin_f32,
                     flush_subnormals, ptr, workspace)
from .topn_det_scan import check_levels, pow2

RLE_TOPN_DET = CudaKernel("rle_topn_det", [P, P, P, P, I32, I32, I32, P])
BIG = 1 << 30


def _i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 that JAX's wrapping int32 arithmetic gives for the exact
    int64 ``x``, kept in int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def check_n(N: int) -> None:
    """N is an int32, as JAX converts a Python int beside an int32 array."""
    if not -(1 << 31) <= N < (1 << 31):
        raise OverflowError(f"N = {N} does not fit an int32")


def rle_topn_det_ref(run_values: torch.Tensor, run_lengths: torch.Tensor, *,
                     N: int, w: int = 4):
    """(head int32[R], tstar int32[R]) of every run, by the closed form,
    its sums wrapping as int32."""
    check_levels(w)
    check_n(N)
    dev = run_values.device
    R = run_values.shape[0]
    if R == 0:
        e = torch.zeros(0, dtype=torch.int32, device=dev)
        return e, e.clone()
    # minima and compares, with subnormals flushed (A25)
    v = flush_subnormals(run_values.to(torch.float32))
    L = _i32(run_lengths.to(torch.int64))
    seen_start = _i32(torch.cumsum(L, 0) - L)
    pos = torch.tensor(float(POS), dtype=torch.float32, device=dev)
    cand = torch.where(seen_start < N, v, pos)
    t0 = torch.minimum(cummin_f32(cand, 0), pos)
    ge = v[:, None] >= t0[:, None] * pow2(w, dev)               # [R, w]
    dL = L[:, None] * ge
    counts_in = _i32(torch.cumsum(dL, 0) - dL)
    levels = torch.arange(w, device=dev)
    A = torch.where(~ge & (counts_in >= N), levels, -1).amax(1)
    C = torch.where(ge & (levels > A[:, None]), counts_in, -1).amax(1)
    head = torch.minimum(_i32(N - seen_start).clamp(min=0), L)
    tstar = torch.where(A < 0, 1, torch.where(C >= 0, _i32(N - C), BIG))
    return head.to(torch.int32), tstar.to(torch.int32)


def rle_topn_det_kernel(run_values: torch.Tensor, run_lengths: torch.Tensor,
                        *, N: int, w: int = 4, block: int = 256):
    """(head int32[R], tstar int32[R]) for f32 run values and int32 lengths;
    R % block == 0, pads (POS, 0)."""
    R = run_values.shape[0]
    if block < 1 or R % block:
        raise ValueError(f"{R} runs are not a multiple of block={block}; pad "
                         "them with (POS, 0)")
    if run_lengths.shape != (R,):
        raise ValueError(f"run_lengths must be [{R}], got "
                         f"{tuple(run_lengths.shape)}")
    if not run_values.is_cuda:
        return rle_topn_det_ref(run_values, run_lengths, N=N, w=w)
    check_levels(w)
    check_n(N)
    check_cuda("run_values", run_values, torch.float32)
    check_cuda("run_lengths", run_lengths, torch.int32, run_values.device)
    dev = run_values.device
    head = torch.empty(R, dtype=torch.int32, device=dev)
    tstar = torch.empty(R, dtype=torch.int32, device=dev)
    if R:
        work = workspace(dev, "rle_topn_det_workspace", R, w)
        RLE_TOPN_DET.launch(dev, ptr(run_values), ptr(run_lengths), ptr(head),
                            ptr(tstar), R, N, w, ptr(work))
    return head, tstar
