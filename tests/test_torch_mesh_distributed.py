"""The port's mesh across processes: two processes of 4 CPU positions each,
joined over gloo, the counterpart of the JAX package's
``scripts/ci_distributed_smoke.py`` (2 processes x 4 devices).

One ``torch.multiprocessing`` spawn runs the whole file's checks; the
processes meet through a ``FileStore`` under the test's temporary
directory (no socket). They import neither ``jax`` nor ``repro`` (this
module imports the JAX package inside the test only, in the parent, which
computes every reference output on the conftest's 8 CPU devices and hands
the children numpy arrays). In each child, with tolerance 0:

* TOP-N det (M=4096, N=32, w=8, S=8): the ``"master"`` and ``"mesh"``
  placements give the same mask, the reference's mesh mask; the resident
  keep holds this process's 4 lanes only, and ``unshard_mask(keep, m,
  mesh)`` gathers the flat mask;
* DISTINCT resident at S=8, a value owned by lane 2 (process 0) repeated in
  lanes 5 and 6 (process 1): the lane base crosses the process boundary;
* a batched mixed-N/w TOP-N resident wave equals the serial loop;
* a mesh ``PruneStream`` closes to the reference stream's keep;
* the tuner in the group (``max_devices=8``, the merge cost fixed so that
  S=8, timings injected): every candidate spreads over 1 position or the
  group's 2, a mesh plan wins the race, and its ``execute_plan`` and the
  cached ``engine_prune(tune="cached")`` give the reference's mask;
* ``run_query`` JOIN on the ``"data"`` axis: each worker's Bloom filters
  ORed over both processes (``all_reduce``) give the answer and the keep of
  one process's 8-position mesh.
"""
import datetime
import os
import sys
import time

import numpy as np
import torch

WORLD = 2
LOCAL = 4
M, N, W, S = 4096, 32, 8, 8
QUERIES = [dict(N=8, w=4), dict(N=N, w=8), dict(N=16, w=6), dict(N=4, w=5)]
DISTINCT = dict(d=16, w=2, policy="fifo")
STREAM_SIZES = (1500, 1024, 1572)
ROWS = 2048
TIMEOUT_S = 240     # the spawn's whole run; a collective gives up at 120 s


def _inputs():
    rng = np.random.default_rng(0)
    host = (rng.random(M) * 1e6 + 1).astype(np.float32)
    n = M // S
    fp = rng.integers(1, 200, M).astype(np.uint32)
    fp[[3 * n - 1, 5 * n + 7, 6 * n + 9]] = 4242  # last of lane 2, then 5, 6
    st = rng.integers(1, 300, sum(STREAM_SIZES)).astype(np.uint32)
    return host, fp, st


def _worker(rank, store_path, refs, out_dir):
    import torch.distributed as dist

    from repro_torch import core as T
    from repro_torch.core import engine as TE
    from repro_torch.core import planner as TP
    from repro_torch.core import streaming as TS
    from repro_torch.core.mesh import mesh_spreads
    from repro_torch.query import QuerySpec, make_rankings, make_uservisits
    from repro_torch.query import run_query

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        group = dist.group.WORLD
        mesh = T.Mesh(("cpu",) * LOCAL, group=group)
        assert mesh.shape == {"shards": WORLD * LOCAL} and mesh.rank == rank
        host, fp, st = _inputs()
        v = torch.from_numpy(host)
        lanes_here = slice(rank * LOCAL, (rank + 1) * LOCAL)

        # TOP-N det at both placements
        masks = {}
        for p2 in ("master", "mesh"):
            res = T.engine_prune("topn_det", v, mode="mesh", shards=S,
                                 mesh=mesh, pass2=p2, N=N, w=W)
            keep = res.keep
            if p2 == "mesh":
                assert keep.shape == (LOCAL, M // S), keep.shape
                assert "entries_kept" not in res.report.counters
                local = keep
                keep = T.unshard_mask(keep, M, mesh)
                assert torch.equal(keep.reshape(S, -1)[lanes_here], local)
            masks[p2] = keep
        assert torch.equal(masks["master"], masks["mesh"])
        assert np.array_equal(masks["mesh"].numpy(), refs["topn_det"])
        assert bool(masks["mesh"][torch.topk(v, N).indices].all())

        # DISTINCT resident: the owner of 4242 is lane 2, on process 0
        res = T.engine_prune("distinct", torch.from_numpy(fp), mode="mesh",
                             shards=S, mesh=mesh, pass2="mesh", **DISTINCT)
        flat = T.unshard_mask(res.keep, M, mesh)
        assert np.array_equal(flat.numpy(), refs["distinct"])

        # the batched wave: one gather, equal to the serial loop
        before = mesh.collectives
        rb = T.engine_prune_batch("topn_det", QUERIES, v, mode="mesh",
                                  shards=S, mesh=mesh, pass2="mesh")
        assert mesh.collectives == before + 1
        assert rb.keep.shape == (len(QUERIES), LOCAL, M // S)
        kb = T.unshard_mask_batch(rb.keep, M, mesh)
        assert np.array_equal(kb.numpy(), refs["batch"])
        for i, q in enumerate(QUERIES):
            one = T.engine_prune("topn_det", v, mode="mesh", shards=S,
                                 mesh=mesh, pass2="mesh", **q)
            assert torch.equal(kb[i], T.unshard_mask(one.keep, M, mesh))

        # the stream: lanes folded on both processes, merged over gloo
        s = TS.PruneStream("distinct", shards=S, mesh=mesh, merge_every=2,
                           obs="off", **DISTINCT)
        lo = 0
        for b in STREAM_SIZES:
            s.fold(torch.from_numpy(st[lo:lo + b]))
            lo += b
        sres = s.close()
        assert np.array_equal(sres.keep.numpy(), refs["stream"])
        assert np.array_equal(sres.live_keep.numpy(), refs["stream_live"])

        # the tuner: one position a process, so the group's size is the one
        # spread a mesh plan may take, whatever max_devices allows
        assert mesh_spreads(S, 8, "cpu") == [WORLD]
        assert mesh_spreads(5, 8, "cpu") == []
        params = dict(N=N, w=W)
        sb = TE.calibrate_merge_cost("topn_det", (v,), params)[1]
        TE.calibrate_merge_cost = lambda algo, streams, params: (
            int(streams[0].shape[0]) / (S * S * sb), sb)
        plans = TP.candidate_plans("topn_det", (v,), params, max_devices=8)
        assert {p.num_devices for p in plans} == {1, WORLD}, plans
        assert {p.shards for p in plans} == {S}, plans

        def resident_first(plan, thunk):
            thunk()         # every process runs every probe's collectives
            return 1.0 if (plan.mode, plan.pass2) == ("mesh", "mesh") else 2.0

        cache = T.PlanCache(os.path.join(out_dir, f"plans{rank}.json"))
        won = TP.tune("topn_det", (v,), params, measure=resident_first,
                      time_budget_s=float("inf"), cache=cache,
                      max_devices=8).plan
        assert (won.mode, won.pass2, won.num_devices) == \
            ("mesh", "mesh", WORLD), won
        got = T.execute_plan("topn_det", v, plan=won, **params)
        assert np.array_equal(got.keep.numpy(), refs["topn_det"])
        got = T.engine_prune("topn_det", v, tune="cached", plan_cache=cache,
                             **params)
        assert np.array_equal(got.keep.numpy(), refs["topn_det"])

        # JOIN over the data axis: the filters ORed over both processes
        data = T.Mesh(("cpu",) * LOCAL, axis="data", group=group)
        tabs = (make_uservisits(ROWS, seed=4, device="cpu"),
                make_rankings(ROWS // 4, seed=5, device="cpu"))
        spec = QuerySpec("join", ("dest_url", "page_url"),
                         dict(nbits=1 << 11))
        got = run_query(spec, tabs, mesh=data)
        one = run_query(spec, tabs, mesh=T.Mesh(("cpu",) * (WORLD * LOCAL),
                                                axis="data"))
        assert torch.equal(got["keep"], one["keep"])
        assert all(torch.equal(a, b) for a, b in zip(got["output"],
                                                     one["output"]))
        assert list(zip(*(t.tolist() for t in got["output"]))) == \
            [tuple(r) for r in refs["join"]]

        assert T.default_mesh(device="cpu").shape == {"shards": WORLD}
        loaded = [n for n in sys.modules
                  if n.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not loaded, loaded
        np.save(os.path.join(out_dir, f"rank{rank}.npy"),
                masks["mesh"].numpy())
    finally:
        dist.destroy_process_group()


def _references():
    """Every reference output, from the JAX package on the conftest's 8 CPU
    devices."""
    import jax
    import jax.numpy as jnp

    from repro import core as J
    from repro.core import streaming as JS
    from repro.query import QuerySpec, make_rankings, make_uservisits
    from repro.query import run_query

    host, fp, st = _inputs()
    mesh = J.default_mesh("shards", WORLD * LOCAL)
    assert len(jax.devices()) >= WORLD * LOCAL
    refs = {}
    r = J.engine_prune("topn_det", jnp.asarray(host), mode="mesh", shards=S,
                       mesh=mesh, pass2="master", N=N, w=W)
    refs["topn_det"] = np.asarray(r.keep)
    r = J.engine_prune("distinct", jnp.asarray(fp), mode="two_pass",
                       shards=S, **DISTINCT)
    refs["distinct"] = np.asarray(r.keep)
    r = J.engine_prune_batch("topn_det", QUERIES, jnp.asarray(host),
                             mode="two_pass", shards=S)
    refs["batch"] = np.asarray(r.keep)
    s = JS.PruneStream("distinct", shards=S, mesh=mesh, merge_every=2,
                       obs="off", **DISTINCT)
    lo = 0
    for b in STREAM_SIZES:
        s.fold(jnp.asarray(st[lo:lo + b]))
        lo += b
    sres = s.close()
    refs["stream"] = np.asarray(sres.keep)
    refs["stream_live"] = np.asarray(sres.live_keep)
    tabs = (make_uservisits(ROWS, seed=4), make_rankings(ROWS // 4, seed=5))
    refs["join"] = run_query(QuerySpec("join", ("dest_url", "page_url"),
                                       dict(nbits=1 << 11)), tabs)["output"]
    return refs


def test_two_processes_over_gloo(tmp_path):
    import torch.multiprocessing as mp

    refs = _references()
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.spawn(_worker, args=(str(tmp_path / "store"), refs, str(out)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):   # raises if a process failed
            assert time.monotonic() < deadline, \
                f"the processes did not finish in {TIMEOUT_S} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    masks = [np.load(out / f"rank{r}.npy") for r in range(WORLD)]
    assert all(np.array_equal(m, refs["topn_det"]) for m in masks)
