"""Op-level analysis of a step: FLOPs, bytes, collectives and live memory.

The counterpart of the reference's ``repro.launch.hlo_analysis``, which
parses XLA's post-SPMD HLO text.  The port has no HLO: a step is the
sequence of aten (and custom) ops it dispatches, and :class:`OpAnalysis`,
a ``TorchDispatchMode``, counts them as they run — on real tensors, or on
fake ones under a ``FakeTensorMode`` (the dry-run), where nothing is
computed or allocated.  It returns the reference's :class:`Totals`:

  * **FLOPs** — PyTorch's flop formulas (``torch.utils.flop_counter``'s
    registry: 2 · |out| · contraction per ``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, the reference's ``_dot_flops``; convolutions), and the
    formulas registered for the port's own kernels (K7 and K7b,
    ``repro_torch.kernels.flash_attention``).  Elementwise ops count no
    FLOPs, as in the reference.  A composite op that reaches the mode
    whole (``matmul``, ``einsum`` under ``inference_mode``) is counted as
    the ops it decomposes into.
  * **HBM bytes** — operands plus outputs of each op: one op stands for
    one kernel, whose intermediates never touch memory (the reference's
    no-cache-reuse model).  Views, aliases and allocations move nothing.
  * **collective bytes** — the payload of each collective (its result's
    bytes; the operand's for a reduce-scatter, the reference's
    ``_collective_payload``), by kind and count: the ``c10d`` ops the
    port's collectives call and DTensor's functional collectives.  A
    collective over a group of one rank moves nothing and is not counted
    (XLA drops it from a one-device program).
  * ``unresolved_whiles`` — always 0: a Python loop dispatches its body
    once per iteration, so no trip count needs recovering.

**Local ops only.**  Under a ``DeviceMesh`` an op on DTensors first reaches
the mode at global shapes; the mode declines it (``NotImplemented``), so
DTensor's own dispatch runs it as this rank's local op, which the mode
then counts at local shapes.  DTensor's sharding propagation runs the op
once more on global-shape fake tensors to learn the output's metadata;
those ops are not counted either (a flag set around the propagator's
metadata pass).  All results are per device, as the reference's.

**Live memory** (``memory=True``): each fresh storage an op creates is
counted while it lives (a weak reference sees it freed); ``peak_bytes``
is the most alive at once, counting only storages created under the mode
— the step's temporaries above its arguments.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}
_FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast", "broadcast_": "broadcast",
}
# ops that allocate, alias or wait: no memory traffic of their own
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "wait_tensor", "_local_scalar_dense",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim", "is_same_size"}


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    coll_counts: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    unresolved_whiles: int = 0
    bytes_by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    flops_by_op: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    peak_bytes: int = 0  # live bytes at the peak (``memory=True``)
    n_ops: int = 0  # ops counted


# >0 while DTensor plans an op: its sharding propagation and metadata pass
_PROPAGATING = 0
# the propagator's entry points across torch releases (2.11 dispatches
# through ``propagate``, later releases through the ``*_non_cached`` ones)
_PLANNERS = ("propagate", "propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


def _flagged(fn):
    """``fn`` with :data:`_PROPAGATING` set, and with any ``FakeTensorMode``
    unset: DTensor plans on metadata, and some of its planning (the
    offsets of a strided shard) reads index tensors' values, which a fake
    tensor has not."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def wrapper(*args, **kwargs):
        global _PROPAGATING
        _PROPAGATING += 1
        try:
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _PROPAGATING -= 1

    wrapper._op_analysis_flagged = True
    return wrapper


@contextlib.contextmanager
def _propagation_flagged():
    """Flag DTensor's planning (:func:`_flagged`) while the mode is on: the
    propagator's :data:`_PLANNERS`, and the strided shards' index
    arithmetic (``_StridedShard``'s ``local_shard_size_and_offset``, which
    both the planner and a redistribution call).  Raises on a torch whose
    ``ShardingPropagator`` has no metadata pass, rather than count global
    shapes."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    targets = [(ShardingPropagator, n) for n in _PLANNERS if n in vars(ShardingPropagator)]
    if not any(n.startswith("_propagate_tensor_meta") for _, n in targets):
        raise RuntimeError("this torch's ShardingPropagator has no _propagate_tensor_meta: "
                           "cannot tell DTensor's metadata pass from local ops")
    targets += [(_StridedShard, n) for n in ("local_shard_size_and_offset",
                                             "_local_shard_size_and_offset")
                if n in vars(_StridedShard)]
    saved = [(cls, n, vars(cls)[n]) for cls, n in targets]
    try:
        for cls, n, fn in saved:
            inner = fn.__func__ if isinstance(fn, staticmethod) else fn
            if not getattr(inner, "_op_analysis_flagged", False):
                wrapped = _flagged(inner)
                setattr(cls, n, staticmethod(wrapped) if isinstance(fn, staticmethod) else wrapped)
        yield
    finally:
        for cls, n, fn in saved:
            setattr(cls, n, fn)


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel (what
    ``func.decompose`` runs)."""
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    return dk in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), dk)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _group_size(namespace: str, args, kwargs) -> int | None:
    """The rank count of a collective's group (None when unknown)."""
    import torch.distributed as dist

    for a in list(args) + list(kwargs.values()):
        if namespace == "c10d" and hasattr(a, "size") and hasattr(a, "rank") \
                and not isinstance(a, torch.Tensor):
            return int(a.size())
        if namespace == "_c10d_functional" and isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import _resolve_process_group

                return int(_resolve_process_group(a).size())
            except Exception:
                return None
    if namespace == "c10d" and dist.is_initialized():
        return dist.get_world_size()
    return None


def _formula_args(func, args, kwargs):
    """``(args, kwargs)`` less an ``out_dtype`` argument (``mm.dtype``,
    ``bmm.dtype``): the flop formulas take the product's shapes and would
    read it as their ``out_shape``."""
    names = [a.name for a in func._schema.arguments]
    if "out_dtype" in names:
        i = names.index("out_dtype")
        args = args[:i] + args[i + 1:]
        kwargs = {k: v for k, v in kwargs.items() if k != "out_dtype"}
    return args, kwargs


def collective_kind(func) -> str | None:
    """The reference's collective kind of an op (None: not a collective)."""
    ns = func.namespace
    name = func._overloadpacket.__name__
    if ns == "c10d":
        return _C10D_KINDS.get(name)
    if ns == "_c10d_functional":
        return _FUNCTIONAL_KINDS.get(name)
    return None


def collective_payload(func, kind: str, args, out) -> int:
    """Result bytes; operand bytes for a reduce-scatter (the larger)."""
    if func.namespace == "c10d":  # in place: the first argument is the result
        result = _nbytes(_tensors(args[0]))
        operand = _nbytes(_tensors(args[1])) if len(args) > 1 else 0
    else:
        result = _nbytes(_tensors(out))
        operand = _nbytes(_tensors(args[0]))
    return max(result, operand) if kind == "reduce-scatter" else result


class OpAnalysis(TorchDispatchMode):
    """Counts the ops dispatched inside it into :attr:`totals`."""

    def __init__(self, memory: bool = False):
        super().__init__()
        self.totals = Totals()
        self.memory = memory
        self._live = 0
        self._stacks = []  # one a nesting: the mode re-enters itself to decompose

    def __enter__(self):
        stack = contextlib.ExitStack()
        stack.enter_context(_propagation_flagged())
        self._stacks.append(stack)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stacks.pop().close()

    def _freed(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops, counted below
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is None and not _PROPAGATING and func.namespace == "aten" \
                and _composite(func):
            # a composite op reaches the mode whole under inference_mode
            # (matmul, einsum): count the ops it decomposes into, as
            # autograd's dispatch would have
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if _PROPAGATING or func.namespace == "prim":  # planning; metadata queries
            return out
        tot = self.totals
        tot.n_ops += 1
        name = func._overloadpacket.__name__
        kind = collective_kind(func)
        if kind is not None:
            size = _group_size(func.namespace, args, kwargs)
            if size is None or size > 1:
                b = collective_payload(func, kind, args, out)
                tot.collective_bytes += b
                tot.coll_by_kind[kind] += b
                tot.coll_counts[kind] += 1
        if formula is not None:
            fargs, fkwargs = _formula_args(func, tuple(args), kwargs)
            f = formula(*fargs, **fkwargs, out_val=out)
            tot.flops += f
            tot.flops_by_op[name] += f
        outs = _tensors(out)
        if not (getattr(func, "is_view", False) or name in _NO_TRAFFIC):
            b = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
            tot.hbm_bytes += b
            tot.bytes_by_op[name] += b
        if self.memory and outs:
            seen = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
            for t in outs:
                st = t.untyped_storage()
                if id(st) in seen:
                    continue
                seen.add(id(st))
                n = st.nbytes()
                self._live += n
                weakref.finalize(st, self._freed, n)
            tot.peak_bytes = max(tot.peak_bytes, self._live)
        return out


def analyze(fn, *args, memory: bool = False, **kwargs):
    """``fn(*args, **kwargs)`` under :class:`OpAnalysis` → ``(result,
    Totals)``."""
    mode = OpAnalysis(memory=memory)
    with mode:
        result = fn(*args, **kwargs)
    return result, mode.totals
