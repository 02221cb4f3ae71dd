"""Numeric sentinels of the pruning stack, the same values as the JAX package's.

NEG is "minus infinity" for f32 value streams (empty TOP-N slots); it is
finite so arithmetic on empty slots stays NaN-free. POS is its positive
counterpart. SENTINEL marks an empty uint32 fingerprint slot and is always
paired with a valid flag, because 0 is a representable fingerprint.
"""
from __future__ import annotations

import numpy as np

NEG = np.float32(-3.4e38)
POS = np.float32(3.4e38)
SENTINEL = np.uint32(0)
