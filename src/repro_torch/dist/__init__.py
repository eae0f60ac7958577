"""Distribution substrate of the port: the object-sharded ``ShardPlan``
(simulated shards on one device, or one shard per rank of a
``torch.distributed`` group), the AND-allreduce schedules and their wire
cost model."""

from repro_torch.dist.shardplan import ShardPlan

__all__ = ["ShardPlan"]
