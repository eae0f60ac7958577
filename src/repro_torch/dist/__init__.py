"""Distribution substrate of the port: the one-shard plan and the wire
cost model of the reduce phase.  Multi-shard plans and collectives over
``torch.distributed`` come with a later slice."""

from repro_torch.dist.plan import ShardPlan

__all__ = ["ShardPlan"]
