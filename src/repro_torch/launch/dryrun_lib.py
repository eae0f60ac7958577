"""Dry-run core: trace every (arch × shape) cell on a mesh and record the
roofline's raw terms per device.

The counterpart of the reference's ``repro.launch.dryrun_lib``, which
lowers and compiles each step against abstract inputs and reads XLA's
HLO.  Here the real step (``make_train_step``, ``make_prefill_step``,
``make_decode_step``) runs once under a ``FakeTensorMode`` — the model,
its placement on the mesh (``shard_model``, ``state_shardings``,
``batch_shardings``, ``cache_shardings``), the optimizer state and the
inputs (``repro_torch.launch.specs``) are fake tensors, on the "cuda"
device by default, holding no memory — and
:class:`~repro_torch.launch.op_analysis.OpAnalysis` counts its local ops:
FLOPs (K7 and K7b through their registered formulas), HBM bytes,
collective bytes by kind, and the live bytes, whose peak above the
arguments is ``memory_analysis["temp_bytes"]``.  The mesh is a
``DeviceMesh`` over a process group (the dry-run CLI's fake group of
256 or 512 ranks, ``repro_torch.launch.dryrun``): each op is this rank's.

Pure library: the group and mesh are the caller's.  The reference's
``_sharded_bytes`` calls ``partitioner.spec_for``, which its
``Partitioner`` lacks (it has ``spec``), so its train, prefill and decode
cells raise; this one calls ``Partitioner.spec``.
"""

from __future__ import annotations

import math
import time
from typing import Any

import torch

from repro_torch.configs import get_config, get_plan, get_shape
from repro_torch.dist.partition import Partitioner, distribute, mesh_shape, tree_map_axes
from repro_torch.launch import op_analysis
from repro_torch.launch import specs as S
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, shape_applicable
from repro_torch.models.transformer import Decoder
from repro_torch.train import step as tstep
from repro_torch.train.optim import get_optimizer, warmup_cosine


def _sharded_bytes(partitioner: Partitioner, axes_tree, abstract_tree) -> int:
    """Exact per-device resident bytes given the sharding specs."""
    total = 0

    def leaf(names, ab):
        nonlocal total
        denom = 1
        for entry in partitioner.spec(names, tuple(ab.shape)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    denom *= partitioner.shape[a]
        total += math.prod(ab.shape) * ab.dtype.itemsize // denom

    tree_map_axes(leaf, axes_tree, abstract_tree)
    return total


def _meta_params(model: Decoder) -> dict:
    return {n: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta")
            for n, p in model.named_parameters()}


def param_bytes(partitioner: Partitioner, model: Decoder) -> int:
    """Per-device bytes of ``model``'s parameters as ``partitioner`` places
    them."""
    return _sharded_bytes(partitioner, model.param_axes(), _meta_params(model))


def optimizer_bytes(partitioner: Partitioner, model: Decoder, optimizer) -> int:
    """Per-device bytes of ``optimizer``'s state over ``model``'s
    parameters (its ``state_axes``; ``init`` on meta tensors)."""
    stacks = model.stacks()
    return _sharded_bytes(partitioner, optimizer.state_axes(model.param_axes(), stacks),
                          optimizer.init(_meta_params(model), stacks))


def cache_bytes(partitioner: Partitioner, cfg: ModelConfig, caches) -> int:
    """Per-device bytes of the caches (``transformer.init_caches``'s)."""
    return _sharded_bytes(partitioner, transformer.cache_axes(cfg), caches)


def build_cell(arch: str, shape_name: str, mesh, *, fsdp=None, optimizer=None,
               baseline: bool = False, device="cuda", cfg: ModelConfig | None = None,
               shape=None):
    """Returns ``(fn, args, aux)`` for one cell: ``fn(*args)`` runs the step.
    Call it under a ``FakeTensorMode`` (as :func:`run_cell` does) for a
    dry run; ``mesh`` None places nothing (one device, no partitioner).

    ``baseline=True`` disables the beyond-paper attention sharding
    constraints, as the reference's.  ``cfg`` and ``shape`` override the
    arch's config and the named shape (a cut depth, a smaller batch)."""
    cfg = get_config(arch) if cfg is None else cfg
    plan = get_plan(arch)
    shape = get_shape(shape_name) if shape is None else shape
    fsdp = plan.fsdp if fsdp is None else fsdp
    opt_name = plan.optimizer if optimizer is None else optimizer

    part = Partitioner(mesh, fsdp=fsdp, constrain_attention=not baseline)
    placed = mesh is not None
    model = Decoder(cfg, device=device, seed=None)
    specs = S.input_specs(cfg, shape, device)
    aux: dict[str, Any] = {"cfg": cfg, "shape": shape, "partitioner": part}
    if placed:
        tstep.shard_model(model, part)
    inputs = {k: v for k, v in specs.items() if k in ("inputs", "labels", "positions")}
    if placed:
        sh = tstep.batch_shardings(part, inputs)
        inputs = {k: distribute(v, sh[k]) for k, v in inputs.items()}

    if shape.kind == "train":
        opt = get_optimizer(opt_name, warmup_cosine(3e-4, 100, 10_000))
        aux["state_bytes"] = param_bytes(part, model) + optimizer_bytes(part, model, opt)
        sh = tstep.model_state_shardings(part, model, opt) if placed else None
        return (tstep.make_train_step(model, opt, part),
                (tstep.init_state(model, opt, sh), inputs), aux)

    aux["state_bytes"] = param_bytes(part, model)
    caches = specs["caches"]
    if placed:
        caches = tstep.shard_caches(caches, tstep.cache_shardings(part, cfg, caches))
    if shape.kind == "prefill":
        step = tstep.make_prefill_step(model, part)

        def fn(params, io):
            with torch.no_grad():
                return step(params, io["inputs"], io["caches"], rope_positions=io.get("positions"))
    else:  # decode: one token at the last position of the caches
        step = tstep.make_decode_step(model, part)
        t = shape.seq_len - 1

        def fn(params, io):
            with torch.no_grad():
                return step(params, io["inputs"], t, io["caches"],
                            rope_positions=io.get("positions"))

        aux["cache_bytes"] = cache_bytes(part, cfg, specs["caches"])
    return fn, (dict(model.named_parameters()), {**inputs, "caches": caches}), aux


def model_flops(cfg: ModelConfig, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (bwd+fwd), 2·N·D inference."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per slot


def _local_storages(tree) -> dict:
    """``{id: nbytes}`` of the storages under ``tree``'s tensors (a
    DTensor's local tensor), each once."""
    from torch.distributed.tensor import DTensor

    out = {}
    for t in op_analysis._tensors(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def memory_analysis(args, out, totals) -> dict:
    """Argument, output, alias (outputs that are arguments' storages) and
    temp (peak live bytes above the arguments) per device."""
    a, o = _local_storages(args), _local_storages(out)
    return {"argument_bytes": sum(a.values()),
            "output_bytes": sum(o.values()),
            "temp_bytes": int(totals.peak_bytes),
            "alias_bytes": sum(n for k, n in o.items() if k in a)}


def _chips(mesh) -> int:
    return math.prod(mesh_shape(mesh).values()) if mesh is not None else 1


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def trace(fn, args) -> tuple:
    """``fn(*args)`` under :class:`~repro_torch.launch.op_analysis.OpAnalysis`
    with live-memory tracking → ``(out, Totals)``."""
    return op_analysis.analyze(fn, *args, memory=True)


def run_cell(arch: str, shape_name: str, mesh, mesh_label: str, *, device="cuda",
             cfg: ModelConfig | None = None, shape=None, **kw) -> dict:
    """One cell's record (the reference's keys, less XLA's own ``xla_*``
    and ``hlo_chars``; ``n_ops`` counts the ops traced).  A cell that
    raises is recorded as ``status="error"``."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = get_shape(shape_name) if shape is None else shape
    ok, why = shape_applicable(cfg, shape)
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_label,
                           "chips": _chips(mesh)}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        with _fake_mode():
            t0 = time.perf_counter()
            fn, args, aux = build_cell(arch, shape_name, mesh, device=device, cfg=cfg,
                                       shape=shape, **kw)
            rec["lower_s"] = round(time.perf_counter() - t0, 1)
            t1 = time.perf_counter()
            out, an = trace(fn, args)
            rec["trace_s"] = round(time.perf_counter() - t1, 1)
            mem = memory_analysis(args, out, an)
        rec.update(
            status="ok",
            flops_per_device=float(an.flops),
            hbm_bytes_per_device=float(an.hbm_bytes),
            collective_bytes_per_device=float(an.collective_bytes),
            collective_by_kind={k: float(v) for k, v in an.coll_by_kind.items()},
            collective_counts={k: int(v) for k, v in an.coll_counts.items()},
            unresolved_whiles=int(an.unresolved_whiles),
            model_flops_global=model_flops(cfg, shape),
            state_bytes_per_device=int(aux.get("state_bytes", 0)),
            cache_bytes_per_device=int(aux.get("cache_bytes", 0)),
            memory_analysis=mem,
            n_ops=int(an.n_ops),
        )
    except Exception as e:  # record the failure — dry-run bugs are bugs
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000])
    return rec


# ---------------------------------------------------------------------------
# The paper's own technique on the production mesh (FCA closure step)
# ---------------------------------------------------------------------------


def run_fca_cell(mesh, mesh_label: str, n_objects: int = 1 << 23, n_attrs: int = 4096,
                 batch: int = 4096, baseline: bool = False, reduce_impl: str = "rsag",
                 method: str = "matmul", device="cuda") -> dict:
    """Trace one MRGanter+ map/reduce round at production scale.

    Context: 8.4M objects × 4096 attributes (≫ census-income), the objects
    sharded over pod × data × model — every rank of the group, which must
    be the mesh's — attributes word-packed.  The map is ``closure_matmul``
    (two products over complement bit-planes; ``baseline``: the plain
    word-wise closure, no products), the reduce ``and_allreduce`` over the
    group and the supports' sum."""
    import torch.distributed as dist

    from repro_torch.core import bitset
    from repro_torch.dist import collectives
    from repro_torch.kernels import ops

    rec: dict[str, Any] = {
        "arch": "fca-mrganter+", "shape": f"closure_{n_objects}x{n_attrs}_B{batch}",
        "mesh": mesh_label, "chips": _chips(mesh),
    }
    try:
        W = bitset.n_words(n_attrs)
        shape = mesh_shape(mesh)
        k = math.prod(shape[a] for a in ("pod", "data", "model") if a in shape)
        if k != dist.get_world_size():
            raise ValueError(f"the objects shard over all {k} ranks of the mesh; the group "
                             f"has {dist.get_world_size()}")
        group = dist.group.WORLD
        if baseline:
            method = "bitwise_naive"
        with _fake_mode() as fake:
            rows = torch.empty((n_objects // k, W), dtype=torch.int32, device=device)
            cands = torch.empty((batch, W), dtype=torch.int32, device=device)
            mask = fake.from_tensor(ops.attr_mask_tensor(n_attrs, W, "cpu")).to(device)

            def shard_body(rows_local, cands):
                if method == "matmul":
                    lc, ls = ops.closure_matmul(rows_local, cands, n_attrs,
                                                n_valid_rows=n_objects // k)
                    lc = lc & mask
                else:
                    lc, ls = ops.batched_closure(rows_local, cands, n_attrs,
                                                 n_valid_rows=n_objects // k,
                                                 use_kernel=False, mask=mask)
                gc = collectives.and_allreduce(lc, group, impl=reduce_impl)
                gs = collectives.sum_allreduce(ls, group)
                return gc & mask, gs

            t0 = time.perf_counter()
            _, an = op_analysis.analyze(shard_body, rows, cands)
            rec["trace_s"] = round(time.perf_counter() - t0, 1)
        rec.update(
            status="ok",
            flops_per_device=float(an.flops),
            hbm_bytes_per_device=float(an.hbm_bytes),
            collective_bytes_per_device=float(an.collective_bytes),
            collective_by_kind={k_: float(v) for k_, v in an.coll_by_kind.items()},
            context_bytes_per_device=n_objects * W * 4 // k,
            model_flops_global=0.0,  # bitwise work — no model products
        )
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}"[:2000])
    return rec
