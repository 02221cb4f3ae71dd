"""The port's token pipeline (``repro_torch.data``) against the JAX
package's (``repro.data``), on the CPU, with tolerance 0.

``corpus`` draws the same documents and qualities; ``_doc_fp`` and the
batched ``doc_fingerprints`` equal the reference's per-document fold;
``batches`` yields the same tokens and labels, batch for batch, and the
same ``stats``, with the dedup kernel (the Pallas kernel in interpret mode
against the port's block walk's plain version) and with the LRU scan. The
corpora stay at a few hundred documents: the reference hashes one document
an eager call.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JPipe
from repro_torch.data import TokenPipeline as TPipe


def _pipes(**kw):
    return JPipe(**kw), TPipe(device="cpu", **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_equal(seed):
    jp, tp = _pipes(vocab=1000, seq_len=32, batch_size=4, seed=seed)
    want = jp.corpus(150, dup_fraction=0.3)
    got = tp.corpus(150, dup_fraction=0.3)
    assert len(got) == len(want)
    for (a, qa), (b, qb) in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        assert qa == qb


@pytest.mark.parametrize("n", [1, 31, 63, 64, 65, 500])
def test_doc_fp_equal(n):
    rng = np.random.default_rng(n)
    docs = [rng.integers(0, 1 << 31, n).astype(np.int32),
            rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            np.zeros(n, np.int32)]
    for d in docs:
        want = JPipe._doc_fp(d)
        assert TPipe._doc_fp(d) == want
    flat, starts, lens = TPipe.upload([(d, 0.5) for d in docs], "cpu")
    got = TPipe.doc_fingerprints(flat, starts, lens)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
        np.uint32), [JPipe._doc_fp(d) for d in docs])


def test_doc_fingerprints_mixed_lengths():
    """One batched call over documents of lengths around the fold's 64,
    shuffled, three of each."""
    rng = np.random.default_rng(5)
    lengths = rng.permutation([1, 2, 31, 32, 63, 64, 65, 127] * 3)
    docs = [(rng.integers(0, 32000, n).astype(np.int32), 0.5)
            for n in lengths]
    flat, starts, lens = TPipe.upload(docs, "cpu")
    got = TPipe.doc_fingerprints(flat, starts, lens)
    np.testing.assert_array_equal(
        got.view(torch.int32).numpy().view(np.uint32),
        [JPipe._doc_fp(d) for d, _ in docs])


def _run(jp, tp, docs):
    want = list(jp.batches(docs))
    got = list(tp.batches(docs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert dataclasses.asdict(tp.stats) == dataclasses.asdict(jp.stats)
    return got


CASES = [
    # (use_kernel, quality_min, dup_fraction, docs, seq_len, batch_size)
    (True, 0.25, 0.3, 240, 16, 2),
    (False, 0.25, 0.3, 240, 16, 2),
    (True, -1.0, 0.0, 120, 16, 3),
    (False, -1.0, 0.5, 200, 16, 2),
    (True, 0.25, 0.5, 300, 12, 4),
    (False, 0.6, 0.5, 300, 24, 5),
]


@pytest.mark.parametrize("use_kernel,quality_min,dup,num,seq,bs", CASES)
def test_batches_equal(use_kernel, quality_min, dup, num, seq, bs):
    jp, tp = _pipes(vocab=256, seq_len=seq, batch_size=bs, seed=num,
                    use_kernel=use_kernel, quality_min=quality_min,
                    dedup_d=32, dedup_w=2)
    docs = tp.corpus(num, dup_fraction=dup)
    got = _run(jp, tp, docs)
    assert got
    if quality_min < 0:
        assert tp.stats.filtered_docs == 0
    if dup == 0.0:
        assert tp.stats.deduped_docs == 0  # no false positives


def test_batches_end_mid_row_and_mid_batch():
    """Survivors whose tokens end inside a row, and rows that end inside a
    batch: the reference leaves both unemitted."""
    jp, tp = _pipes(vocab=256, seq_len=16, batch_size=3, seed=4)
    docs = tp.corpus(90, dup_fraction=0.3)
    _run(jp, tp, docs)
    flat, starts, lens = tp.upload(docs, "cpu")
    keep = tp.dedup_keep(tp.doc_fingerprints(flat, starts, lens))
    quality = torch.tensor([q for _, q in docs], dtype=torch.float32)
    surv = (keep & tp.quality_keep(quality)).numpy()
    total = sum(d.size for (d, _), s in zip(docs, surv) if s)
    assert total % 17 and (total // 17) % 3
    rows = tp.pack(flat, starts, lens, torch.from_numpy(surv))
    want = np.concatenate([d for (d, _), s in zip(docs, surv) if s])
    n = rows.numel()
    assert n == (total // 17) // 3 * 3 * 17
    np.testing.assert_array_equal(rows.reshape(-1).numpy(), want[:n])


def test_batches_on_few_survivors():
    """Survivors too short for one batch: nothing is emitted."""
    jp, tp = _pipes(vocab=64, seq_len=128, batch_size=8, seed=3,
                    quality_min=0.9)
    docs = tp.corpus(20)
    assert _run(jp, tp, docs) == []
    assert tp.stats.emitted_batches == 0 and tp.stats.seen_docs == 20


def test_iter_raises():
    with pytest.raises(TypeError, match="batches"):
        iter(TPipe(vocab=8, seq_len=4, batch_size=1, device="cpu"))
