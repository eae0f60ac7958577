"""Process-group meshes for the 2-D (candidate × object) ShardPlan.

The counterpart of the reference's ``make_local_mesh(cand=, pod=)``: the
ranks of the default ``torch.distributed`` group form a mesh whose axes
run major to minor as the reference's do — the candidate axis first, then
``pod``, then ``data``.  Rank ``r`` holds candidate block ``r // (pod ·
data)`` and object shard ``r % (pod · data)``, so its **object subgroup**
(the ranks of its candidate block, which share every object reduce) is a
run of consecutive ranks and its **candidate subgroup** (the ranks holding
its object shard, which gather each other's survivor blocks) is a stride.

``dist.new_group`` must be called by every rank, for every subgroup, in
the same order; :func:`make_local_mesh` does that and keeps the two
subgroups this rank belongs to.  The LM tier's production meshes have no
counterpart here yet.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class GroupMesh:
    """This rank's place in a cand × pod × data mesh of process groups."""

    shape: tuple[tuple[str, int], ...]  # (axis, size), major to minor
    object_group: object
    cand_group: object  # None on a 1-D mesh (cand == 1)
    object_axes: tuple[str, ...]
    cand_axes: tuple[str, ...]


def make_local_mesh(data: int | None = None, pod: int = 1, cand: int = 1) -> GroupMesh:
    """The mesh over the ranks of the default group: ``cand`` candidate
    blocks × ``pod`` × ``data`` object shards (``data`` defaults to what
    the world size leaves).  Needs an initialized ``torch.distributed``."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized torch.distributed group")
    world = dist.get_world_size()
    if cand < 1 or pod < 1:
        raise ValueError(f"cand and pod must be >= 1, got cand={cand}, pod={pod}")
    if data is None:
        data = world // (pod * cand)
    if data < 1 or cand * pod * data != world:
        raise ValueError(
            f"a {cand} x {pod} x {data} (cand x pod x data) mesh does not cover "
            f"the {world} ranks of the group"
        )
    dims = ([("cand", cand)] if cand > 1 else []) + ([("pod", pod)] if pod > 1 else [])
    dims.append(("data", data))
    n_obj = pod * data
    rank = dist.get_rank()
    # every rank creates every subgroup, in one order: object groups first
    object_group = cand_group = None
    if cand == 1:
        object_group = dist.group.WORLD
    else:
        for c in range(cand):
            g = dist.new_group(list(range(c * n_obj, (c + 1) * n_obj)))
            if rank // n_obj == c:
                object_group = g
        for o in range(n_obj):
            g = dist.new_group([c * n_obj + o for c in range(cand)])
            if rank % n_obj == o:
                cand_group = g
    return GroupMesh(
        shape=tuple(dims),
        object_group=object_group,
        cand_group=cand_group,
        object_axes=tuple(a for a, _ in dims if a != "cand"),
        cand_axes=("cand",) if cand > 1 else (),
    )
