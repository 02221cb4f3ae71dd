#!/usr/bin/env python
"""Read the order in which XLA's CPU code sums a short Pallas Count-Min
block, and hold the port's rule to it (ROADMAP Queue 3 A30).

``ops.cms_build`` of the JAX package sums each block of ``block`` keys of
a row as ``jnp.sum(onehot * w, axis=0)``. At 32 keys or fewer that is one
fused loop, and LLVM picks its order: the loop in key order, or vectorised
(lanes, unrolled accumulators, a halving tree, an epilogue). f32 adds that
flush subnormals do not associate, so the table's bits show the order.

For every shape (block, width, rows) the script builds tables with the JAX
package on the CPU from weights that make the order visible (both signs
near FLT_MIN, where the flushes decide the counters, and non-integer ones,
where the rounding does), on keys of a few distinct values so that a block
holds many hits of a counter, then:

- default: compares the port's plain build (``repro_torch.kernels.ops.
  cms_build``, the rule ``cms_sketch.short_block_order``) bit for bit and
  prints each shape that disagrees;
- ``--fit``: prints, for each row of each shape, the candidate orders
  (VF, UF, epi) of ``cms_sketch.short_block_sum`` that reproduce it.

Run from the repository root, on the CPU (small shapes, a few processes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/probe_xla_short_blocks.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/probe_xla_short_blocks.py \
        --blocks 14 20 22 --widths 7 16 --rows 2 --fit

The dumped LLVM IR of one shape (``XLA_FLAGS=--xla_dump_to=DIR``, files
``*select_reduce_fusion*.ir-with-opt.ll`` for row 0 and
``*dynamic-update-slice_fusion*`` for the rows that add into the table)
shows the same orders.
"""
from __future__ import annotations

import argparse
import itertools
from multiprocessing import Pool

import numpy as np

FLT_MIN = np.float32(np.finfo(np.float32).tiny)
CANDIDATES = [(1, 1, 1)] + [(vf, uf, e) for vf in (2, 4, 8) for uf in (1, 2, 4)
                            for e in (0, 1, 2, 4, 8) if e <= vf]
WIDTHS = list(range(1, 17)) + [64, 1024, 4096]


def _data(m: int, seed: int, kind: str):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 20, 4).astype(np.uint32)
    k = pool[rng.integers(0, 4, m)]
    if kind == "normal":
        w = (rng.standard_normal(m) * 10).astype(np.float32)
    else:
        w = ((rng.integers(8, 40, m) * rng.choice([-1, 1], m)).astype(
            np.float32) * (FLT_MIN / 8)).astype(np.float32)
    return k, w


def _fit_row(k, w, want_row, block, width, r):
    """The candidate orders that reproduce row r of the reference."""
    import torch

    from repro_torch.kernels import cms_sketch as C
    from repro_torch.kernels.common import flush_subnormals, ftz_add

    m = k.shape[0]
    mp = -(-m // block) * block
    kp = torch.zeros(mp, dtype=torch.int64)
    kp[:m] = torch.from_numpy(k.astype(np.int64))
    wp = torch.zeros(mp)
    wp[:m] = torch.from_numpy(w)
    col = C.row_hashes(kp.to(torch.uint32), r + 1, width, 0, "kernel")[:, r]
    nb = mp // block
    used = torch.unique(col)
    L = torch.where(col.reshape(nb, 1, block) == used[None, :, None],
                    flush_subnormals(wp).reshape(nb, 1, block), 0.0)
    L[:, :, 0] = ftz_add(L[:, :, 0], torch.zeros_like(L[:, :, 0]))
    L = L.reshape(-1, block)
    want = torch.from_numpy(np.array(want_row))[used].view(torch.int32)
    ok = []
    for c in CANDIDATES:
        step = c[0] * c[1]
        if c[0] > 1 and (block if c[2] == 0 else block // step * step) < step:
            continue
        s = C.short_block_sum(L, c).reshape(nb, -1)
        t = torch.zeros(used.numel())
        for b in range(nb):
            t = ftz_add(t, s[b])
        if bool((t.view(torch.int32) == want).all()):
            ok.append(c)
    return ok


def _probe(args):
    block, width, rows, fit = args
    import jax.numpy as jnp
    import torch

    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops

    out = []
    for seed, kind in enumerate(("flt", "normal", "flt", "normal")):
        k, w = _data(2040, seed, kind)
        want = np.asarray(jops.cms_build(jnp.asarray(k), jnp.asarray(w),
                                         rows=rows, width=width, block=block))
        if fit:
            out.append([_fit_row(k, w, want[r], block, width, r)
                        for r in range(rows)])
            continue
        got = tops.cms_build(torch.from_numpy(k), torch.from_numpy(w),
                             rows=rows, width=width, block=block).numpy()
        bad = int((got.view(np.int32) != want.view(np.int32)).sum())
        if bad:
            out.append(f"{kind} seed {seed}: {bad} counters apart")
    if fit:  # the orders that every input agrees on, row by row
        out = [sorted(set.intersection(*(set(o[r]) for o in out)))
               for r in range(rows)]
    return block, width, rows, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, nargs="*",
                    default=list(range(1, 33)))
    ap.add_argument("--widths", type=int, nargs="*", default=WIDTHS)
    ap.add_argument("--rows", type=int, nargs="*", default=[1, 2, 3, 4])
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--procs", type=int, default=4)
    a = ap.parse_args()
    shapes = [(b, w, r, a.fit) for r, w, b in
              itertools.product(a.rows, a.widths, a.blocks)]
    bad = 0
    with Pool(a.procs) as pool:
        for block, width, rows, out in pool.imap(_probe, shapes):
            if a.fit:
                print(f"block={block} width={width} rows={rows}: "
                      + "; ".join(f"row {r} {o}" for r, o in enumerate(out)))
            elif out:
                bad += 1
                print(f"block={block} width={width} rows={rows}: "
                      + ", ".join(out))
    if not a.fit:
        print(f"{len(shapes)} shapes, {bad} apart from the reference")


if __name__ == "__main__":
    main()
