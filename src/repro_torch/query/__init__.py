"""repro_torch.query — device-resident concept store, batched query engine,
and streaming updates.

  * :mod:`repro_torch.query.store`  — ``ConceptStore``: plan-sharded
    context + extent tables, replicated intent table, the paper's
    two-level hash index (head-attr × popcount) as device tensors, and the
    covering relation materialized by a subset-test matmul.
  * :mod:`repro_torch.query.engine` — ``QueryEngine``: fixed-slot
    micro-batched closure / lookup / traversal / top-k / extent / rule
    queries; each micro-batch is one ``ShardPlan.spmd`` round, so B
    queries cost one collective, not B.
  * :mod:`repro_torch.query.stream` — ``StreamUpdater``: batched
    device-side Godin insertion with double-buffered snapshots.
"""

from repro_torch.query.engine import QueryConfig, QueryEngine, QueryStats
from repro_torch.query.store import ConceptStore, Snapshot
from repro_torch.query.stream import StreamUpdater, UpdateReceipt

__all__ = [
    "ConceptStore",
    "Snapshot",
    "QueryConfig",
    "QueryEngine",
    "QueryStats",
    "StreamUpdater",
    "UpdateReceipt",
]
