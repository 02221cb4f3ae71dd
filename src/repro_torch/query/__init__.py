"""Query layer on one device: tables, switch pruning, master completion,
the TPC-H subset suite (``workloads``) and the §7.2 reliability protocol's
host model (``protocol``)."""
from .engine import QuerySpec, run_queries, run_query
from .tables import (PlainColumn, Table, make_products_ratings, make_rankings,
                     make_uservisits)
from .workloads import (SUITE, SuiteQuery, engine_streams, make_lineitem,
                        make_orders, tpch_tables)
from .protocol import (SwitchReliability, MultiQuerySwitchReliability,
                       combined_forward_mask, simulate_lossy_stream,
                       simulate_lossy_stream_multi)
