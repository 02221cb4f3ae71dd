"""Hand-written CUDA kernels for the TOP-N, DISTINCT, SKYLINE, Count-Min,
Bloom and GROUP BY pruning hot path.

Each kernel lives in ``csrc/`` with its plain PyTorch version beside its
wrapper (``ref.py`` for pass 1, ``parallel.py`` for pass 2,
``cms_sketch.py`` for Count-Min, ``bloom_filter.py`` for Bloom,
``groupby_scan.py`` for the GROUP BY scan, ``topn_det_scan.py`` for the
threshold ladder, ``rle_scan.py`` for the run-level RLE TOP-N). Public
entry points are in ``ops.py``.
"""
from . import ops, parallel, ref
