"""Process-group meshes: the FCA ShardPlan's candidate × object groups and
the LM tier's ``DeviceMesh``.

The counterpart of the reference's ``repro.launch.mesh``: the ranks of the
default ``torch.distributed`` group form a mesh whose axes run major to
minor as the reference's do — the candidate axis first, then ``pod``,
``data`` and ``model``.  Rank ``r`` sits at ``(c, p, d, m)`` with ``r =
((c · pod + p) · data + d) · model + m``.  Its **object subgroup** (the
ranks of its candidate block and model index, which share every object
reduce) and its **candidate subgroup** (the ranks holding its object
shard and model index, which gather each other's survivor blocks) are the
FCA plan's; with ``model == 1`` they are a run of consecutive ranks and a
stride, as before the model axis.  ``device_mesh`` is the same layout as a
``torch.distributed.device_mesh.DeviceMesh`` (dims ``cand`` and ``pod``
only when larger than 1, then ``data`` and ``model``, as the reference's
``make_local_mesh``), which the partitioner (``repro_torch.dist.partition``)
places the LM state and activations on.  ``shape`` keeps the FCA plan's
axes (candidate and object axes only): the FCA plans read only
``object_axes`` and their groups and results do not depend on ``model``.

``dist.new_group`` must be called by every rank, for every subgroup, in
the same order; :func:`make_local_mesh` does that and keeps the two
subgroups this rank belongs to.  :func:`make_production_mesh` is the
reference's 16 × 16 pod (2 × 16 × 16 over two pods): it needs a group of
256 (512) ranks, and raises otherwise, as the reference raises on too few
devices.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclasses.dataclass(frozen=True)
class GroupMesh:
    """This rank's place in a cand × pod × data × model mesh of process
    groups."""

    shape: tuple[tuple[str, int], ...]  # the FCA plan's (axis, size), major to minor
    object_group: object
    cand_group: object  # None on a 1-D mesh (cand == 1)
    object_axes: tuple[str, ...]
    cand_axes: tuple[str, ...]
    device_mesh: DeviceMesh | None = None  # cand?, pod?, data, model
    model: int = 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_local_mesh(data: int | None = None, model: int = 1, pod: int = 1,
                    cand: int = 1, *, device_type: str | None = None) -> GroupMesh:
    """The mesh over the ranks of the default group: ``cand`` candidate
    blocks × ``pod`` × ``data`` object shards × ``model`` (``data``
    defaults to what the world size leaves).  Needs an initialized
    ``torch.distributed`` group (NCCL: a CUDA ``DeviceMesh``; gloo: CPU;
    ``device_type`` overrides that, as the dry-run does over its fake
    group, whose tensors are fake CUDA tensors)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized torch.distributed group")
    world = dist.get_world_size()
    if cand < 1 or pod < 1 or model < 1:
        raise ValueError(f"cand, pod and model must be >= 1, got cand={cand}, pod={pod}, "
                         f"model={model}")
    if data is None:
        data = world // (pod * cand * model)
    if data < 1 or cand * pod * data * model != world:
        raise ValueError(
            f"a {cand} x {pod} x {data} x {model} (cand x pod x data x model) mesh does not "
            f"cover the {world} ranks of the group"
        )
    dims = ([("cand", cand)] if cand > 1 else []) + ([("pod", pod)] if pod > 1 else [])
    dims.append(("data", data))
    n_obj = pod * data
    rank = dist.get_rank()
    c_me, o_me, m_me = rank // (n_obj * model), rank // model % n_obj, rank % model

    def at(c: int, o: int, m: int) -> int:
        return (c * n_obj + o) * model + m

    # every rank creates every subgroup, in one order: object groups first
    object_group = cand_group = None
    if cand == 1 and model == 1:
        object_group = dist.group.WORLD
    else:
        for c in range(cand):
            for m in range(model):
                g = dist.new_group([at(c, o, m) for o in range(n_obj)])
                if (c, m) == (c_me, m_me):
                    object_group = g
    if cand > 1:
        for o in range(n_obj):
            for m in range(model):
                g = dist.new_group([at(c, o, m) for c in range(cand)])
                if (o, m) == (o_me, m_me):
                    cand_group = g
    mesh_dims = dims + [("model", model)]
    device_mesh = DeviceMesh(device_type or _device_type(),
                             torch.arange(world).reshape([s for _, s in mesh_dims]),
                             mesh_dim_names=tuple(a for a, _ in mesh_dims))
    return GroupMesh(
        shape=tuple(dims),
        object_group=object_group,
        cand_group=cand_group,
        object_axes=tuple(a for a, _ in dims if a in ("pod", "data")),
        cand_axes=("cand",) if cand > 1 else (),
        device_mesh=device_mesh,
        model=model,
    )


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> GroupMesh:
    """16 × 16 data × model over 256 ranks, or 2 × 16 × 16 pod × data ×
    model over 512; raises ``ValueError`` on a group of another size."""
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialized torch.distributed group")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {' x '.join(map(str, shape))} needs "
                         f"{math.prod(shape)} ranks; the group has {dist.get_world_size()}")
    return make_local_mesh(data=16, model=16, pod=2 if multi_pod else 1,
                           device_type=device_type)

