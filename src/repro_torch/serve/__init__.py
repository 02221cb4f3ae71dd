"""Serving: Cheetah logit TOP-N pruning and request dedup."""
from .engine import RequestCache, pruned_topk
