"""Serving: batched greedy decode, Cheetah logit TOP-N pruning, request
dedup."""
from .engine import RequestCache, ServeEngine, TopNTrace, pruned_topk
