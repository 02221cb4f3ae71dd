"""The port stands alone: no JAX, nothing of the JAX package, no quiet CPU."""
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, convert, core
from repro_torch.data import TokenPipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.models import LM
from repro_torch.query import tables
from repro_torch.serve import RequestCache, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)\b")


def test_no_jax_import_lines():
    bad = [f"{p.relative_to(ROOT)}:{i}"
           for p in PORT_FILES
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if IMPORT.match(line)]
    assert not bad


def test_imports_with_jax_blocked():
    """Every module of the port and chip_smoke's imports load with jax,
    jaxlib, repro and ml_dtypes unimportable; none of them is loaded
    afterwards."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
            sys.modules[name] = None
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        import pkgutil, importlib
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(mod.name)
        import chip_smoke
        from repro_torch.kernels import common, ops, parallel, ref
        loaded = [n for n, m in sys.modules.items() if m is not None and (
            n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))]
        assert not loaded, loaded
        print("isolated")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


CONSTRUCTORS = [
    lambda: tables.make_uservisits(16),
    lambda: tables.make_rankings(16),
    lambda: tables.Table.from_numpy("t", {"a": np.zeros(4, np.float32)}),
    lambda: convert.table_from_numpy({"a": np.zeros(4, np.float32)}),
    lambda: convert.topn_rand_state_from_numpy(np.zeros((4, 2), np.float32)),
    lambda: convert.distinct_state_from_numpy(
        np.zeros((4, 2), np.uint32), np.zeros((4, 2), bool),
        np.zeros(4, np.int32)),
    lambda: convert.distinct_kernel_state_from_numpy(
        np.zeros((4, 2), np.float32), np.zeros((4, 2), np.float32),
        np.zeros((4, 2), np.float32)),
    lambda: convert.skyline_state_from_numpy(np.zeros((4, 2), np.float32),
                                             np.zeros(4, np.float32)),
    lambda: convert.count_min_from_numpy(np.zeros((3, 8), np.int32)),
    lambda: convert.bloom_filter_from_numpy(np.zeros(64, bool)),
    lambda: convert.groupby_state_from_numpy(
        np.zeros((4, 2), np.uint32), np.zeros((4, 2), np.float32),
        np.zeros((4, 2), bool)),
    lambda: core.skyline_init(4, 2),
    lambda: core.groupby_init(4, 2),
    lambda: core.having_init(),
    lambda: tables.make_products_ratings(),
    lambda: TokenPipeline(vocab=64, seq_len=8, batch_size=1).batches(
        [(np.arange(40, dtype=np.int32), 0.5)]),
    lambda: RequestCache().dedup(["q1"]),
    lambda: core.default_mesh(),
    lambda: core.default_mesh("data", 2),
    lambda: LM(configs.get_smoke("qwen3-1.7b")).init(0),
    lambda: convert.lm_params_from_numpy(configs.get_smoke("qwen3-1.7b"),
                                         {}),
    lambda: ServeEngine(_cpu_lm()),
    lambda: launch_serve.main([]),
]


def _cpu_lm():
    lm = LM(configs.get_smoke("qwen3-1.7b"))
    lm.init(0, device="cpu")
    return lm


@pytest.mark.parametrize("make", CONSTRUCTORS)
def test_default_device_is_the_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_lm_modules_stand_alone():
    """The LM harness (configs, models, launch, serve) loads with jax,
    jaxlib, repro and ml_dtypes blocked and serves a smoke model on the
    CPU there."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
            sys.modules[name] = None
        sys.path[:0] = [{str(ROOT / 'src')!r}]
        import numpy as np
        from repro_torch import configs, launch, models, serve
        from repro_torch.launch import serve as launch_serve
        out = launch_serve.main(["--device", "cpu", "--max-new", "2"])
        assert out.shape == (3, 2)
        loaded = [n for n, mod in sys.modules.items() if mod is not None
                  and n.split(".")[0] in ("jax", "jaxlib", "repro",
                                          "ml_dtypes")]
        assert not loaded, loaded
        print("isolated")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_launch_serve_without_a_card_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0
    assert "RuntimeError" in res.stderr and "CUDA" in res.stderr


BATCH_MODULES = ("repro_torch.core.batched", "repro_torch.core.batch_engine",
                 "repro_torch.kernels.batch_walks")


def test_batch_modules_stand_alone():
    """The multi-query modules load with jax, jaxlib and repro blocked, and
    every batched walk is a kernel of ``parallel.KERNELS`` with its own
    launch count."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        sys.path[:0] = [{str(ROOT / 'src')!r}]
        import importlib
        for name in {BATCH_MODULES!r}:
            importlib.import_module(name)
        from repro_torch.kernels import batch_walks, parallel
        from repro_torch import core, query
        assert all(k in parallel.KERNELS for k in batch_walks.BATCH_KERNELS)
        names = [k.name for k in parallel.KERNELS]
        assert len(names) == len(set(names))
        assert core.engine_prune_batch and core.unshard_mask_batch
        assert core.BatchPruneResult and query.run_queries
        print("isolated")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_mesh_module_stands_alone():
    """``core.mesh`` loads with jax, jaxlib and repro blocked, and so does
    every module that imports it; the engine's mesh mode runs on CPU
    positions there."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        sys.path[:0] = [{str(ROOT / 'src')!r}]
        import torch
        from repro_torch.core import mesh
        from repro_torch import core
        assert core.Mesh is mesh.Mesh and core.default_mesh
        m = core.Mesh(("cpu",) * 4)
        x = torch.arange(64, dtype=torch.float32)
        r = core.engine_prune("topn_det", x, mode="mesh", shards=8, mesh=m,
                              pass2="mesh", N=4, w=4)
        assert r.keep.shape == (8, 8) and m.collectives == 1
        loaded = [n for n, mod in sys.modules.items() if mod is not None
                  and n.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not loaded, loaded
        print("isolated")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "isolated" in res.stdout


def test_batch_walks_check_the_wave():
    """A query wider than the wave's cap is refused before any walk."""
    from repro_torch.kernels import batch_walks

    x = torch.zeros(8, dtype=torch.float32)
    with pytest.raises(ValueError, match="wcap"):
        batch_walks.topn_pass1_batch(x, d=[4], w=[3], seeds=[0], shards=1,
                                     dcap=4, wcap=2)


def test_top_level_surface_covers_the_reference():
    """``repro_torch.__all__`` holds every name of the JAX package's
    top-level ``__all__``, read from its source as text."""
    import ast

    import repro_torch

    tree = ast.parse((ROOT / "src" / "repro" / "__init__.py").read_text())
    ref = next(ast.literal_eval(n.value) for n in tree.body
               if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "__all__"
                       for t in n.targets))
    assert {"engine_prune_batch", "run_queries", "PlanCache"} <= set(ref)
    assert set(ref) <= set(repro_torch.__all__)
    assert all(hasattr(repro_torch, n) for n in repro_torch.__all__)
