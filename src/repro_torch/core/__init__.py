"""The pruning abstraction and the TOP-N / DISTINCT / SKYLINE / HAVING /
JOIN / FILTER / GROUP BY pruners (paper §3-§5), and the dictionary and RLE
encodings they prune before decode.

A pruner maps a stream D to a keep mask selecting a subset with
Q(subset) = Q(D); the master completes the query on the survivors.
"""
from .pruning import PruneResult, compact, compact_argsort, prune_rate_vs_opt
from .hashing import (by_value, fingerprint, fingerprint_bits_thm4, mix32,
                      hash_mod, hash_mod_dyn, multi_hash)
from .distinct import (DistinctState, distinct_prune, master_complete_distinct,
                       opt_keep_distinct, thm1_bound)
from .topn import (TopNDetState, TopNRandState, topn_det_init,
                   topn_det_prune, topn_rand_prune, thm2_w, thm2_opt_d,
                   thm3_forwarded_bound, opt_keep_topn, master_complete_topn)
from .skyline import (SkylineState, skyline_init, skyline_prune,
                      skyline_oracle, opt_keep_skyline,
                      master_complete_skyline, score_aph, score_sum)
from .sketches import (BloomFilter, CountMin, bloom_build, bloom_query,
                       cms_build, cms_query)
from .join import (join_prune, join_prune_asymmetric, master_complete_join,
                   join_oracle)
from .filter import (Pred, And, Or, TRUE, relax, basic_preds, evaluate,
                     evaluate_truthtable, filter_prune, master_complete_filter)
from .groupby import (GroupByState, groupby_init, groupby_prune,
                      master_complete_groupby, groupby_oracle)
from .having import (having_init, having_prune, master_complete_having,
                     having_oracle)
from .encoding import (DictEncoding, dict_encode, normalize_encodings,
                       rle_encode, rle_expand)
from .mesh import Mesh, default_mesh
from .engine import (ALGORITHMS, MODES, PASS2, DistinctMerged,
                     TopNDetMerged, apply_merged, calibrate_merge_cost,
                     engine_prune, execute_plan, merge_states, reset_caches,
                     shard_stack, unshard_mask)
from . import batched
from .batch_engine import (MODES_BATCH, BatchPruneResult,
                           engine_prune_batch, execute_plan_batch,
                           unshard_mask_batch)
from .planner import (SwitchProfile, ResourceFootprint, footprint,
                      pack_queries, rule_count, PackingPlan,
                      MultiSwitchPlan, plan_multi_switch, optimal_shards,
                      optimal_pass2, pass2_time, MEASURED_MERGE_COSTS,
                      QueryBatchPlan, plan_query_batch,
                      RESIDENT_OVERHEAD_ENTRIES, optimal_merge_interval,
                      DEFAULT_STALENESS_RATE, Plan, TuneResult,
                      TUNE_MODES, analytic_plan, candidate_plans, tune,
                      resolve_plan)
from .options import DECODE_MODES, ExecOptions
from .plancache import PlanCache, cache_key
from .streaming import (PruneStream, StreamResult, engine_prune_stream,
                        lane_view)

__all__ = [n for n in dir() if not n.startswith("_")]
