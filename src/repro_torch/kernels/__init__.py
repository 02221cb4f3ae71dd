"""Hand-written CUDA kernels for the TOP-N, DISTINCT, SKYLINE and Count-Min
pruning hot path.

Each kernel lives in ``csrc/`` with its plain PyTorch version beside its
wrapper (``ref.py`` for pass 1, ``parallel.py`` for pass 2,
``cms_sketch.py`` for Count-Min). Public entry points are in ``ops.py``.
"""
from . import ops, parallel, ref
