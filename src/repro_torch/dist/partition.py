"""Logical-axis partitioner: maps the models' *logical* axis names onto mesh
axes, and those onto ``torch.distributed.tensor`` placements.

The port of the reference's ``repro.dist.partition``.  The rules are its
Megatron-style rules:

  * ``batch``/activation leading dims   → the data axes (``pod``, ``data``)
  * tensor-parallel dims (``vocab``, ``ffn``, ``heads``, ``kv``,
    ``experts``, ``inner``, ``lru``, ``moe_d``, ``seq_model``) → ``model``
  * ``embed`` → the data axes when ``fsdp=True`` (ZeRO-3-style parameter
    sharding along the reduction dim), replicated otherwise
  * anything else (``layers``, ``head_dim``, ``conv``, ``seq_kv``, None)
    → replicated

A dim is only sharded when the mesh-axis product divides its size, and each
mesh axis is used at most once per array (first dim wins), so reduced test
configs with tiny head counts degrade to replication instead of erroring.

:meth:`Partitioner.spec` gives the reference's ``PartitionSpec`` entries as
a tuple (None, an axis name, or a tuple of names per dim) and reads only
``mesh.shape``, so a shape-only mesh (``SimpleNamespace(shape={...})``)
resolves specs without any process.  Everything else needs a
``DeviceMesh`` (the mesh itself, or the ``device_mesh`` of a
``repro_torch.launch.mesh.GroupMesh``): a :class:`Sharding` is the mesh and
one placement per mesh dim — ``Shard(d)`` on the mesh dims a spec entry
names (a dim split over several mesh dims is split major to minor, as the
reference's tuple entries are), ``Replicate()`` on the others — and
:meth:`Partitioner.__call__`, the reference's activation constraint,
redistributes a DTensor to it (a plain tensor passes through, as an
unsharded array does through ``with_sharding_constraint`` under no mesh).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

_DATA_AXES = ("pod", "data")
_MODEL_AXES = ("model",)

RULES: dict[str, tuple[str, ...]] = {
    "batch": _DATA_AXES,
    "vocab": _MODEL_AXES,
    "ffn": _MODEL_AXES,
    "heads": _MODEL_AXES,
    "kv": _MODEL_AXES,
    "experts": _MODEL_AXES,
    "inner": _MODEL_AXES,
    "lru": _MODEL_AXES,
    "moe_d": _MODEL_AXES,
    "seq_model": _MODEL_AXES,
}


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, a ``GroupMesh`` (its device
    mesh) or anything with a ``shape`` mapping (or ``(axis, size)`` pairs)."""
    if mesh is None:
        return {}
    mesh = getattr(mesh, "device_mesh", None) or mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def object_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry an object/batch partition, pod-major.

    Shared vocabulary between the LM data-parallel path and the FCA
    ShardPlan (whose context rows shard over the same axes)."""
    shape = mesh_shape(mesh)
    return tuple(a for a in _DATA_AXES if a in shape)


@contextlib.contextmanager
def replicate_plain():
    """Plain tensors that meet DTensors count as replicated, as under
    ``implicit_replication`` — but nested, restoring the setting it found
    (``implicit_replication`` turns it off on leaving, even inside another).
    The setting belongs to the thread; see :func:`replicate_plain_in_backward`."""
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def replicate_plain_in_backward(loss: torch.Tensor) -> None:
    """Turn the setting of :func:`replicate_plain` on in the thread that runs
    ``loss``'s backward (on the card a worker thread of the autograd
    engine, which does not inherit it), by a hook on ``loss``'s gradient,
    the first thing that thread runs of this backward."""

    def hook(grad):
        DTensor._op_dispatcher._allow_implicit_replication = True

    loss.register_hook(hook)


class Sharding(NamedTuple):
    """A ``DeviceMesh`` and one placement per mesh dim (the port's
    ``NamedSharding``)."""

    mesh: object
    placements: tuple


def distribute(x: torch.Tensor, sharding: Sharding | None) -> torch.Tensor:
    """``x`` (the whole array, the same on every rank) as a DTensor with
    ``sharding``: each rank keeps its own chunk, with no communication.
    A DTensor is redistributed instead; ``sharding=None`` returns ``x``."""
    if sharding is None:
        return x
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements, src_data_rank=None)


def even(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with every dim but the last sharded evenly: a dim that
    sharding propagation split unevenly (7 rows over 2 ranks) is gathered,
    so that the dims can be flattened (a reshape).  Anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim < x.dim() - 1
                 and x.shape[p.dim] % mesh.size(i) else p
                 for i, p in enumerate(x.placements))
    return x if want == tuple(x.placements) else x.redistribute(mesh, want)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) or a is None for a in x)


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(names, *leaves)`` over a tree of dicts, lists and NamedTuples
    whose leaves are tuples of logical names, and trees of its structure."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, v, *(t[k] for t in trees)) for k, v in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(tree_map_axes(fn, v, *(getattr(t, f) for t in trees))
                                 for f, v in zip(axes_tree._fields, axes_tree)))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_map_axes(fn, v, *(t[i] for t in trees))
                               for i, v in enumerate(axes_tree))
    raise TypeError(f"not an axes tree: {type(axes_tree).__name__}")


class Partitioner:
    def __init__(self, mesh, *, fsdp: bool | None = False, constrain_attention: bool = True):
        self.mesh = mesh
        self.fsdp = bool(fsdp)
        self.constrain_attention = constrain_attention
        self.shape = mesh_shape(mesh)
        self.device_mesh = None if mesh is None else (getattr(mesh, "device_mesh", None)
                                                      or mesh)

    # -- rule resolution ---------------------------------------------------

    def _axes_for(self, name) -> tuple[str, ...]:
        if name is None:
            return ()
        if name == "embed":
            return _DATA_AXES if self.fsdp else ()
        return RULES.get(name, ())

    def _present(self, mesh_axes: tuple[str, ...]) -> tuple[str, ...]:
        return tuple(a for a in mesh_axes if a in self.shape)

    def axis_size(self, mesh_axes: tuple[str, ...]) -> int:
        return math.prod(self.shape[a] for a in self._present(mesh_axes))

    def dim_shards(self, name: str, size: int) -> int:
        """Shard count a dim of ``size`` named ``name`` would get (1 = none)."""
        k = self.axis_size(self._axes_for(name))
        return k if k > 1 and size % k == 0 else 1

    def spec(self, names, shape) -> tuple:
        """The PartitionSpec entries for logical ``names`` (len == ndim),
        divisibility- and reuse-checked against ``shape``."""
        used: set[str] = set()
        entries = []
        for name, size in zip(names, shape):
            axes = self._present(self._axes_for(name))
            if axes and not (used & set(axes)):
                k = math.prod(self.shape[a] for a in axes)
                if k > 1 and size % k == 0:
                    used.update(axes)
                    entries.append(axes if len(axes) > 1 else axes[0])
                    continue
            entries.append(None)
        return tuple(entries)

    def placements(self, spec) -> tuple:
        """One placement per mesh dim for the spec entries ``spec``."""
        dims = {}
        for d, entry in enumerate(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    dims[a] = d
        return tuple(Shard(dims[a]) if a in dims else Replicate() for a in self.shape)

    # -- public API --------------------------------------------------------

    def __call__(self, x: torch.Tensor, *names) -> torch.Tensor:
        """Activation sharding constraint by logical dim names (None = any):
        a DTensor is redistributed, anything else passes through."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        want = self.placements(self.spec(names, x.shape))
        return x if tuple(x.placements) == want else x.redistribute(self.device_mesh, want)

    def sharding(self, names, shape) -> Sharding:
        return Sharding(self.device_mesh, self.placements(self.spec(names, shape)))

    def replicated(self) -> Sharding:
        return Sharding(self.device_mesh, tuple(Replicate() for _ in self.shape))

    def batch_spec(self, shape, batch_dim: int = 0) -> Sharding:
        names = [None] * len(shape)
        names[batch_dim] = "batch"
        return self.sharding(names, shape)

    def tree_shardings(self, axes_tree, abstract_tree):
        """Tree of :class:`Sharding` from a logical-axes tree and a tree of
        its structure whose leaves have ``.shape``."""
        return tree_map_axes(lambda names, leaf: self.sharding(names, leaf.shape),
                             axes_tree, abstract_tree)

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` replicated on every mesh dim (a partial sum summed, a shard
        gathered); a plain tensor as a replicated DTensor."""
        x = self.as_dtensor(x)
        want = self.replicated().placements
        return x if tuple(x.placements) == want else x.redistribute(self.device_mesh, want)

    def as_dtensor(self, x: torch.Tensor) -> torch.Tensor:
        """A plain tensor (the same on every rank) as a replicated DTensor on
        the mesh, with no copy; a DTensor as it is."""
        if isinstance(x, DTensor):
            return x
        return DTensor.from_local(x, self.device_mesh, self.replicated().placements,
                                  run_check=False)

    def local(self, fn, out_placements, in_placements):
        """``fn`` on each rank's local tensors (``local_map``): the inputs are
        redistributed to ``in_placements`` (None: not a DTensor), the outputs
        wrapped with ``out_placements`` (one sequence, or a tuple of them for
        several outputs).  The gradient of an input replicated on a mesh dim
        where an output is sharded or partial is a partial sum there (each
        rank computed a different part of the output from it); elsewhere it
        takes the input's placement."""
        from torch.distributed.tensor.experimental import local_map

        several = isinstance(out_placements[0], (list, tuple))
        outs = [list(o) for o in out_placements] if several else [list(out_placements)]
        grads = tuple(
            None if pl is None else [
                Partial() if isinstance(p, Replicate)
                and any(not isinstance(o[i], Replicate) for o in outs) else p
                for i, p in enumerate(pl)]
            for pl in in_placements)
        return local_map(fn, out_placements=tuple(outs) if several else outs[0],
                         in_placements=tuple(None if pl is None else list(pl)
                                             for pl in in_placements),
                         in_grad_placements=grads, device_mesh=self.device_mesh,
                         redistribute_inputs=True)

    def coordinate(self, axes: tuple[str, ...]) -> int:
        """This rank's index along the product of ``axes`` (major to minor)."""
        idx = 0
        for a in self._present(axes):
            idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
        return idx
