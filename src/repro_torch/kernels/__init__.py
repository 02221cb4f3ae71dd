"""Hand-written CUDA kernels for the TOP-N and DISTINCT pruning hot path.

Each kernel lives in ``csrc/`` with its plain PyTorch version beside its
wrapper (``ref.py`` for pass 1, ``parallel.py`` for pass 2). Public entry
points are in ``ops.py``.
"""
from . import ops, parallel, ref
