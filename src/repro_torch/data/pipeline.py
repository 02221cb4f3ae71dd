"""Training data pipeline with Cheetah pruning as a first-class stage.

Per-host token streams flow through:
  1. DISTINCT dedup: document fingerprints through the d x w cache kernel
     (paper Ex. 2/8), so repeated documents never reach the model.
  2. FILTER quality pruning: predicate decomposition (Ex. 1) on a cheap
     metadata column; the "master" (the training step) sees survivors.
  3. Packing of the survivors' tokens into fixed [B, S+1] rows.
The train step is the master: Q = "the unique, quality-passing training
stream", and Q(A_Q(D)) = Q(D) holds by the algorithms' guarantees.

``corpus()`` draws on the host exactly what the JAX package's draws.
``batches()`` uploads the corpus once, as a flat int32 buffer and document
offsets, and runs every stage on the device: one gather and 64 masked
Horner steps for the fingerprints, the DISTINCT kernel, the FILTER, and one
gather of the survivors' tokens, cut into rows and batches. Its batches and
stats equal the reference's, token for token.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import core
from ..core.hashing import _M32, as_u32, to_u32
from ..device import resolve_device
from ..kernels import ops as kops

FP_TOKENS = 64   # tokens a document fingerprint folds


@dataclasses.dataclass
class PipelineStats:
    seen_docs: int = 0
    deduped_docs: int = 0
    filtered_docs: int = 0
    emitted_batches: int = 0


@dataclasses.dataclass
class TokenPipeline:
    """Synthetic sharded corpus -> dedup -> filter -> fixed-shape batches.

    ``device``: where ``batches`` runs (None: the card)."""
    vocab: int
    seq_len: int
    batch_size: int
    dedup_d: int = 1024
    dedup_w: int = 4
    dedup_block: int = 16  # small blocks: a near-scan pruning rate
    quality_min: float = 0.25
    seed: int = 0
    use_kernel: bool = True
    stats: PipelineStats = dataclasses.field(default_factory=PipelineStats)
    device: object = None

    def corpus(self, num_docs: int, dup_fraction: float = 0.3):
        """Synthetic docs with controlled duplication + quality scores:
        a list of (int32 tokens, quality) on the host."""
        rng = np.random.default_rng(self.seed)
        n_unique = max(1, int(num_docs * (1 - dup_fraction)))
        base = [rng.integers(0, self.vocab, rng.integers(32, 4 * self.seq_len))
                .astype(np.int32) for _ in range(n_unique)]
        # each unique doc appears once; the remainder are true duplicates
        docs = [(b, float(rng.random())) for b in base]
        for _ in range(num_docs - n_unique):
            docs.append((base[rng.integers(0, n_unique)], float(rng.random())))
        rng.shuffle(docs)
        return docs

    def __iter__(self):
        raise TypeError("call .batches(docs) with a corpus")

    def batches(self, docs):
        """An iterator of {tokens, labels} int32 [B, S] batches on the
        device, after the pruning stages. The stages run, and ``stats``
        counts, when the first batch is asked for."""
        return self._batches(docs, resolve_device(self.device))

    def _batches(self, docs, dev):
        flat, starts, lens = self.upload(docs, dev)
        # ---- stage 1: DISTINCT dedup on document fingerprints
        keep = self.dedup_keep(self.doc_fingerprints(flat, starts, lens))
        self.stats.seen_docs += len(docs)
        self.stats.deduped_docs += int((~keep).sum())
        # ---- stage 2: FILTER on metadata (quality predicate)
        quality = torch.from_numpy(np.asarray(
            [q for _, q in docs], np.float64).astype(np.float32)).to(dev)
        fkeep = self.quality_keep(quality)
        self.stats.filtered_docs += int((keep & ~fkeep).sum())
        # ---- stage 3: pack to fixed [B, S+1] rows
        rows = self.pack(flat, starts, lens, keep & fkeep)
        for arr in rows:
            self.stats.emitted_batches += 1
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    @staticmethod
    def upload(docs, dev):
        """The corpus on ``dev`` as one flat int32 buffer, with int64
        document starts and lengths."""
        lens = np.fromiter((d.size for d, _ in docs), np.int64, len(docs))
        flat = (np.concatenate([d for d, _ in docs]).astype(np.int32,
                                                           copy=False)
                if docs else np.zeros(0, np.int32))
        starts = np.cumsum(lens) - lens
        return (torch.from_numpy(flat).to(dev),
                torch.from_numpy(starts).to(dev),
                torch.from_numpy(lens).to(dev))

    @staticmethod
    def doc_fingerprints(flat: torch.Tensor, starts: torch.Tensor,
                         lens: torch.Tensor) -> torch.Tensor:
        """uint32 [docs]: ``_doc_fp`` of every document. The first <= 64
        tokens of each are gathered into one [docs, 64] matrix and hashed
        in one call; the fold ``out = out * 31 + v (mod 2^32)`` runs as 64
        Horner steps, each masked to the documents that have that token."""
        j = torch.arange(FP_TOKENS, device=flat.device)
        valid = j < lens[:, None]
        out = torch.zeros(lens.shape[0], dtype=torch.int64,
                          device=flat.device)
        if flat.numel():
            idx = torch.where(valid, starts[:, None] + j, 0)
            h = as_u32(core.fingerprint(flat[idx]))
            for t in range(FP_TOKENS):
                out = torch.where(valid[:, t], (out * 31 + h[:, t]) & _M32,
                                  out)
        return to_u32(out)

    def dedup_keep(self, fps: torch.Tensor) -> torch.Tensor:
        """bool keep mask of stage 1: the FIFO block kernel, or the LRU
        scan without ``use_kernel``."""
        if self.use_kernel:
            return kops.distinct_prune(fps, d=self.dedup_d, w=self.dedup_w,
                                       block=self.dedup_block)
        return core.distinct_prune(fps, d=self.dedup_d, w=self.dedup_w).keep

    def quality_keep(self, quality: torch.Tensor) -> torch.Tensor:
        """bool keep mask of stage 2: quality > quality_min."""
        formula = core.Pred("quality", "gt", self.quality_min)
        return core.filter_prune(formula, {"quality": quality},
                                 use_truthtable=False).keep

    def pack(self, flat: torch.Tensor, starts: torch.Tensor,
             lens: torch.Tensor, survivors: torch.Tensor) -> torch.Tensor:
        """int32 [batches, B, S+1]: the survivors' tokens in document order,
        gathered once, cut into (S+1)-token rows, B rows a batch. The
        trailing partial row and partial batch are dropped, as the
        reference's packing loop leaves them unemitted."""
        row, B = self.seq_len + 1, self.batch_size
        sel = torch.nonzero(survivors).flatten()
        ls = lens[sel]
        ends = torch.cumsum(ls, 0)
        total = int(ends[-1]) if ls.numel() else 0
        nb = total // row // B
        need = nb * B * row
        if not need:
            return flat.new_empty((0, B, row))
        # only the documents that start before the last kept token
        k = int(((ends - ls) < need).sum())
        itype = torch.int32 if flat.numel() < (1 << 31) else torch.int64
        base = (starts[sel[:k]] - (ends[:k] - ls[:k])).to(itype)
        idx = torch.repeat_interleave(base, ls[:k],
                                      output_size=int(ends[k - 1]))[:need]
        idx += torch.arange(need, dtype=itype, device=flat.device)
        return flat.index_select(0, idx).view(nb, B, row)

    @staticmethod
    def _doc_fp(tokens: np.ndarray) -> np.uint32:
        """One document's fingerprint, as the reference computes it: the
        first 64 token hashes folded as ``out * 31 + v (mod 2^32)``."""
        h = core.fingerprint(torch.from_numpy(
            tokens.astype(np.uint32).view(np.int32))).view(torch.int32)
        out = np.uint32(0)
        for v in h.numpy().view(np.uint32).ravel()[:FP_TOKENS]:
            out = np.uint32((int(out) * 31 + int(v)) & 0xFFFFFFFF)
        return out
