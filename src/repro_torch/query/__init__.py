"""Query layer on one device: tables, switch pruning, master completion."""
from .engine import QuerySpec, run_queries, run_query
from .tables import PlainColumn, Table, make_rankings, make_uservisits
