#!/usr/bin/env python3
"""Two source trees of the PyTorch port on one card, in turns: the pruned
fractions of ``ops.topn_prune_parallel`` / ``ops.distinct_prune_parallel``
and the device time of their pass 1 (S = 128, B = 256, the block kernels)
on the main path's 2^25-row uservisits table.

    python3 scripts/compare_pass1_block.py PARENT_SRC CHANGE_SRC

Each ``*_SRC`` is a ``src`` directory holding ``repro_torch`` (a parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists, and this tree's ``src``). The trees run parent, change, change,
parent, each in a process of its own that builds its own kernels; every
run prints one JSON line. Needs one CUDA card.
"""
import subprocess
import sys

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import common, ops as O, parallel as P
from repro_torch.query import make_uservisits

common.library()
uv = make_uservisits(1 << 25, seed=0, device="cuda")
xs, fs = uv.cols["ad_revenue"], uv.cols["source_ip"]


def ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        t.append(a.elapsed_time(b))
    return sorted(t)[len(t) // 2]


kt = O.topn_prune_parallel(xs, shards=128, block=256, d=512, w=8)
kd = O.distinct_prune_parallel(fs, shards=128, block=256, d=4096, w=4)
print(json.dumps({
    "tree": sys.argv[2],
    "topn_pruned": round(1 - float(kt.float().mean()), 6),
    "distinct_pruned": round(1 - float(kd.float().mean()), 6),
    "topn_pass1_ms": ms(lambda: P.topn_shard_states_kernel(
        xs, shards=128, block=256, d=512, w=8)),
    "distinct_pass1_ms": ms(lambda: P.distinct_shard_states_kernel(
        fs, shards=128, block=256, d=4096, w=4))}), flush=True)
'''


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = sys.argv[1:]
    rc = 0
    for tree, src in (("parent", parent), ("change", change),
                      ("change", change), ("parent", parent)):
        r = subprocess.run([sys.executable, "-c", CHILD, src, tree],
                           capture_output=True, text=True)
        print(r.stdout.strip() or r.stderr[-2000:], flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
