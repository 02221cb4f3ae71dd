"""Serving launcher: batched requests -> dedup -> prefill/decode with
per-shard logit pruning, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --max-new 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_smoke
from ..device import resolve_device
from ..models import LM
from ..serve import RequestCache, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    lm = LM(cfg)
    lm.init(0, device=dev)
    eng = ServeEngine(lm, n_logit_shards=16, device=dev)
    rc = RequestCache(device=dev)

    rng = np.random.default_rng(0)
    requests = [f"request-{i % max(args.batch - 1, 1)}"
                for i in range(args.batch * 2)]  # contains duplicates
    fresh, _ = rc.dedup(requests)
    print(f"[serve] {len(requests)} requests -> {len(fresh)} after dedup")
    B = len(fresh)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, args.prompt_len))
                               .astype(np.int32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    print(f"[serve] {B}x{args.max_new} tokens in {dt:.3f}s "
          f"({B * args.max_new / dt:.1f} tok/s) on {dev}")
    print("[serve] sample:", out[0][:10].tolist())
    return out


if __name__ == "__main__":
    main()
