"""Query layer on one device: tables, switch pruning, master completion,
and the TPC-H subset suite (``workloads``)."""
from .engine import QuerySpec, run_queries, run_query
from .tables import PlainColumn, Table, make_rankings, make_uservisits
from .workloads import (SUITE, SuiteQuery, engine_streams, make_lineitem,
                        make_orders, tpch_tables)
