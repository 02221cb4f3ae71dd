"""Serving with Cheetah pruning on the logit path and on the request queue.

Logit TOP-N pruning (paper Ex. 3 -> vocab-sharded decode): with the vocab
sharded over the model axis, the exact global top-k needs a full [B, V]
gather. Instead each shard forwards only its local top-k candidates, a
provable superset of the global top-k (any global top-k element is a local
top-k element of its shard), and the "master" finishes on n_shards x k
candidates. The wire sees k * shards values instead of V.

On top of that per-step pruning, ``ServeEngine.generate(...,
track_topn=N)`` folds every step's candidate wire into a streaming TOP-N
switch (``core.PruneStream("topn_det")``, one ``topn_det_pass1`` launch a
step): a *global* top-N over the whole generation, resolved exactly at the
end by ``master_complete_topn`` without materializing the [steps, B, V]
logit history.

Request dedup (Ex. 2/8): prompts are fingerprinted and folded into a
persistent streaming DISTINCT cache (``core.PruneStream``), so a repeated
prompt hits the response cache instead of the model, also when it arrives
in a later call than its first occurrence.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..core.hashing import _M32, as_u32, fingerprint, to_u32
from ..core.streaming import PruneStream
from ..core.topn import master_complete_topn
from ..device import resolve_device

# the 32-bit image of each float dtype that orders as XLA's total order
_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF),
         torch.float16: (torch.int16, 0x7FFF),
         torch.bfloat16: (torch.int16, 0x7FFF)}


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: (values, int64 indices).

    lax.top_k orders floats by XLA's total order (+NaN on top, a NaN with
    its sign set below -inf, -0 below +0) and gives the lower index first
    among equal values; ``torch.topk`` promises no order on ties. So the
    top k of a unique int64 key are taken: the value's order image in the
    high 32 bits, the reversed index in the low 32.
    """
    n = x.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"top_k needs 0 <= k <= {n}, got k={k}")
    if x.dtype in _BITS:
        it, low = _BITS[x.dtype]
        bits = x.view(it)
        key = torch.where(bits < 0, bits ^ low, bits).to(torch.int64)
    else:
        # every key within int32's range, so that the shift cannot wrap
        key = (as_u32(x) - (1 << 31) if x.dtype == torch.uint32
               else x.to(torch.int64))
    rev = n - 1 - torch.arange(n, dtype=torch.int64, device=x.device)
    idx = torch.topk((key << 32) | rev, k, dim=-1, sorted=True).indices
    return torch.gather(x, -1, idx), idx


def pruned_topk(logits: torch.Tensor, k: int, n_shards: int):
    """Exact top-k via per-shard pruning. logits [B, V] -> (vals, idx).

    Equal to ``lax.top_k(logits, k)`` (values, indices and their order) for
    any V divisible by n_shards; communication V -> n_shards * k. float64
    and int64 logits are narrowed to 32 bits first, as JAX narrows them.
    """
    if logits.dtype == torch.float64:
        logits = logits.to(torch.float32)
    elif logits.dtype == torch.int64:
        logits = logits.to(torch.int32)
    B, V = logits.shape
    if V % n_shards:
        raise ValueError(f"the vocab {V} is not a multiple of "
                         f"n_shards={n_shards}")
    Vs = V // n_shards
    lv, li = _top_k(logits.reshape(B, n_shards, Vs), k)  # local top-k
    li = li + torch.arange(n_shards, device=li.device)[None, :, None] * Vs
    cand_v = lv.reshape(B, n_shards * k)                 # the pruned wire
    cand_i = li.reshape(B, n_shards * k)
    fv, fi = _top_k(cand_v, k)                           # master completion
    return fv, torch.gather(cand_i, 1, fi)


def _prompt_words(prompts) -> tuple[np.ndarray, np.ndarray]:
    """(uint32 [n, W] words, bool [n, W] valid) of the prompts' UTF-8 bytes,
    packed as ``RequestCache._fp`` packs one: padded to at least 4 bytes,
    4 bytes a word, big-endian, a short last word holding its bytes in its
    low end. Vectorised over the prompts."""
    data = [p.encode().ljust(4, b"\0") for p in prompts]
    n = len(data)
    L = np.fromiter(map(len, data), np.int64, n)
    nw = -(-L // 4)
    W = int(nw.max())
    pid = np.repeat(np.arange(n), L)
    pos = np.arange(int(L.sum())) - np.repeat(np.cumsum(L) - L, L)
    word = pos // 4
    k = np.minimum(4, L[pid] - 4 * word)            # bytes in this word
    col = 4 * word + 4 - k + pos % 4
    out = np.zeros((n, 4 * W), np.uint8)
    out[pid, col] = np.frombuffer(b"".join(data), np.uint8)
    words = out.view(">u4").astype(np.uint32)
    return words, np.arange(W) < nw[:, None]


def prompt_fingerprints(prompts, device) -> torch.Tensor:
    """uint32 [n] fingerprints of ``prompts`` on ``device``: the packed
    words hashed by ``fingerprint`` in one call, each prompt's hashes XOR-
    folded by halving. Equal to ``RequestCache._fp`` prompt by prompt."""
    words, valid = _prompt_words(prompts)
    w = torch.from_numpy(words.view(np.int32)).to(device)
    h = torch.where(torch.from_numpy(valid).to(device),
                    as_u32(fingerprint(w.view(torch.uint32))), 0)
    while h.shape[1] > 1:
        if h.shape[1] % 2:
            h = torch.nn.functional.pad(h, (0, 1))
        h = h[:, 0::2] ^ h[:, 1::2]
    return to_u32(h[:, 0])


@dataclasses.dataclass
class RequestCache:
    """DISTINCT-pruned request queue: repeated prompts are served from
    cache. A d x w LRU cache on 32-bit prompt fingerprints, held as
    *streaming* switch state on ``device`` (None: the card): one resident
    lane folded per ``dedup`` call, so dedup works across calls."""
    d: int = 256
    w: int = 4
    device: object = None
    _responses: dict = dataclasses.field(default_factory=dict)
    _stream: PruneStream | None = dataclasses.field(default=None,
                                                    repr=False)

    def _ensure_stream(self) -> PruneStream:
        if self._stream is None:
            # one lane: dedup is a sequential queue; retain=False keeps the
            # unbounded request stream from accumulating
            self._stream = PruneStream("distinct", shards=1, merge_every=1,
                                       retain=False, d=self.d, w=self.w)
        return self._stream

    def dedup(self, prompts: list) -> tuple[list, list]:
        """(the prompts the cache has not seen, every prompt's fingerprint
        as an int). One fold of the call's fingerprints on the device and
        one read of its live mask and fingerprints back to the host."""
        dev = resolve_device(self.device)
        if not prompts:
            return [], []
        fps = prompt_fingerprints(prompts, dev)
        stream = self._ensure_stream()
        keep = stream.live_mask(stream.fold(fps))
        fp_host, keep_host = torch.stack(
            [as_u32(fps), keep.to(torch.int64)]).cpu().numpy()
        fresh = [p for p, k in zip(prompts, keep_host) if k]
        if obs.default_level() != "off":
            obs.REGISTRY.record("serve.dedup_requests", len(prompts))
            obs.REGISTRY.record("serve.dedup_pruned",
                                len(prompts) - len(fresh))
        return fresh, fp_host.tolist()

    def reset(self):
        """Drop the switch state (not the response cache)."""
        if self._stream is not None:
            self._stream.reset()

    @staticmethod
    def _fp(prompt: str) -> int:
        """One prompt's fingerprint, as the reference computes it: its bytes
        packed into uint32 words, hashed, the hashes XOR-folded."""
        data = np.frombuffer(prompt.encode().ljust(4, b"\0"), np.uint8)
        arr = np.zeros(max(1, -(-len(data) // 4)), np.uint32)
        for i, b in enumerate(data):
            arr[i // 4] = (arr[i // 4] << 8) | int(b)
        h = as_u32(fingerprint(torch.from_numpy(arr.view(np.int32))
                               .view(torch.uint32)))
        out = 0
        for v in h.tolist():
            out ^= v
        return out & _M32

    def put(self, fp: int, response):
        self._responses[fp] = response

    def get(self, fp: int):
        return self._responses.get(fp)


@dataclasses.dataclass
class TopNTrace:
    """Global top-N over a generation's candidate wire.

    values: f32[N] descending; entries: total candidates folded;
    shipped: candidates the streaming switch would have forwarded
    upstream (live mask), so the wire saving is 1 - shipped/entries.
    report: the tracking stream's ``ExecReport`` (None when obs is off).
    """

    values: np.ndarray
    entries: int
    shipped: int
    report: object | None = None


@dataclasses.dataclass
class ServeEngine:
    """Batched greedy decoding of ``lm`` (a ``models.LM``) on ``device``
    (None: the card, which raises RuntimeError when there is none); the
    model's parameters must be there."""
    lm: object
    rules: object | None = None
    n_logit_shards: int = 16
    topk: int = 8
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        have = self.lm.device
        if (have.type, have.index or 0) != (self.device.type,
                                            self.device.index or 0):
            raise ValueError(f"the model's parameters are on {have}, the "
                             f"engine runs on {self.device}")

    def _step(self, cache, tok, pos: int):
        """One decode step: (greedy tokens int32 [B], the candidate wire
        f32 [B * shards * topk], cache)."""
        lg, cache = self.lm.decode_step(cache, tok, pos, self.rules)
        B, V = lg.shape
        shards = self.n_logit_shards if V % self.n_logit_shards == 0 else 1
        _, idx = pruned_topk(lg, 1, shards)
        # the pruned wire: each vocab shard's local top-k candidates
        cand_v, _ = _top_k(lg.reshape(B, shards, V // shards), self.topk)
        return idx[:, 0].to(torch.int32), cand_v.reshape(-1), cache

    def generate(self, prompt_tokens, max_new: int, enc_inputs=None,
                 track_topn: int | None = None):
        """Greedy decode. Returns np.int32[B, max_new] tokens; with
        ``track_topn=N`` returns ``(tokens, TopNTrace)``: the exact global
        top-N candidate logits across all decode steps, folded into a
        ``topn_det`` stream step by step. The tokens stay on the device
        until the end: one read back a call."""
        tokens = torch.as_tensor(prompt_tokens, device=self.device)
        B, S = tokens.shape
        cache = self.lm.init_cache(B, S + max_new)
        if enc_inputs is not None:
            enc_out = self.lm.encode(
                torch.as_tensor(enc_inputs, device=self.device), self.rules)
            cache["cross"] = self.lm.build_cross_cache(enc_out)
        _, cache = self.lm.prefill_via_decode(cache, tokens, self.rules)
        tok = tokens[:, -1]
        out = []
        tracker = cands = None
        if track_topn:
            tracker = PruneStream("topn_det", shards=1, merge_every=1,
                                  N=track_topn, w=8)
            cands = []
        for t in range(max_new):
            tok, cand_v, cache = self._step(cache, tok, S + t - 1)
            out.append(tok)
            if tracker is not None:
                tracker.fold(cand_v)
                cands.append(cand_v)
        toks = torch.stack(out, dim=1).cpu().numpy()
        if tracker is None:
            return toks
        res = tracker.close()
        vals, _ = master_complete_topn(torch.cat(cands), res.keep,
                                       track_topn)
        return toks, TopNTrace(values=vals.cpu().numpy(),
                               entries=int(res.keep.shape[0]),
                               shipped=int(res.live_keep.sum()),
                               report=res.report)
