"""Bitwise-AND all-reduce — the paper's reduce phase (Theorem 2) — in the
reference's three interchangeable schedules, plus its wire-cost model.

  * ``allgather`` — every shard gathers the full [B, W] local-closure
    block and AND-folds it with a log₂ tree.  One ring pass,
    k·(k-1)·B·W words on the wire.
  * ``rsag``      — reduce-scatter + all-gather: shards exchange 1/k-sized
    batch chunks (all-to-all), AND-fold their owned chunk, then all-gather
    the folded chunks.  2·(k-1)·B·W words; same arithmetic.
  * ``pmin``      — unpack words to 0/1 attribute lanes and take the
    elementwise min (AND of bits == min of bits), then repack.  Costs 32×
    the wire bytes of the packed schedules unless ``n_attrs`` bounds the
    unpacked width.

The object-axis reduces take a ``torch.distributed`` subgroup as well as
the world group, so a 2-D plan reduces over its object subgroup; the
candidate axis of a 2-D plan gathers its survivor blocks with
:func:`all_gather_blocks` over the candidate subgroup.

The reduce axis is one of two things:

  * :data:`SIM_AXIS` — the simulated object partition: ``x`` carries the
    k shards as its leading dimension ``[k, B, W]`` on one device, and the
    result is the reduced block on every shard, ``[k, B, W]`` (an expanded
    view; the twin of ``jax.vmap`` with a named axis);
  * a ``torch.distributed`` ``ProcessGroup`` — ``x`` is this rank's
    ``[B, W]`` block and the result is the reduced ``[B, W]``.  NCCL and
    gloo have no bitwise-AND reduction, so the schedules are built from
    ``all_gather_into_tensor``, ``all_to_all_single`` and
    ``all_reduce(MIN)``.

All three are reductions over the AND semigroup, so the results are
bit-identical for every shard count and schedule.  Bitsets are int32
views of uint32 words; bit 31 unpacks right under the arithmetic shift
(``(x >> 31) & 1``) and repacks through an int64 sum, so no int32
``1 << 31`` overflows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import ALL_ONES, pack_lanes, unpack_lanes

IMPLS = ("allgather", "rsag", "pmin")

# The simulated object partition's axis: the leading dimension of ``x``.
SIM_AXIS = "objpart"


def _is_simulated(axis) -> bool:
    if isinstance(axis, str):
        if axis != SIM_AXIS:
            raise ValueError(f"unknown reduce axis {axis!r}; use {SIM_AXIS!r} or a ProcessGroup")
        return True
    return False


def axis_size(axis, x: torch.Tensor | None = None) -> int:
    """Number of shards along ``axis`` (the leading dimension of ``x`` on
    the simulated axis)."""
    if _is_simulated(axis):
        return x.shape[0]
    return dist.get_world_size(axis)


def and_fold(x: torch.Tensor) -> torch.Tensor:
    """AND-fold over the leading axis via the reference's log₂ tree
    (adjacent pairs, the odd tail carried)."""
    n = x.shape[0]
    while n > 1:
        half = n // 2
        head = x[: 2 * half]
        x = torch.cat([head[0::2] & head[1::2], x[2 * half :]])
        n = x.shape[0]
    return x[0]


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[k · x.shape[0], ...]``: every rank's ``x`` stacked in rank order."""
    k = dist.get_world_size(group)
    out = torch.empty((k * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    # in every torch since 1.13; 2.13 deprecates it for all_gather_single,
    # which older releases lack
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _pad_batch(x: torch.Tensor, k: int) -> torch.Tensor:
    """Pad the batch (second-to-last) axis to a multiple of ``k`` with
    all-ones rows, the AND identity."""
    pad = -x.shape[-2] % k
    if not pad:
        return x
    fill = torch.full((*x.shape[:-2], pad, x.shape[-1]), ALL_ONES, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill], dim=-2)


def and_allreduce(x: torch.Tensor, axis, *, impl: str = "rsag",
                  n_attrs: int | None = None) -> torch.Tensor:
    """Global bitwise-AND of the shards' ``[B, W]`` blocks across ``axis``.

    ``n_attrs`` (optional) bounds the unpacked width of ``pmin`` to the
    real attribute count.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown reduce impl {impl!r}; choose {IMPLS}")
    sim = _is_simulated(axis)
    k = axis_size(axis, x)
    if k == 1:
        return x
    B, W = x.shape[-2:]

    if impl == "allgather":
        g = x if sim else _all_gather(x, axis).reshape(k, B, W)
        out = and_fold(g)

    elif impl == "rsag":
        xp = _pad_batch(x, k)
        Bp = xp.shape[-2]
        if sim:
            # shard i owns chunk i and folds every shard's copy of it: the
            # fold runs over the source-shard axis of [src, chunk, Bp/k, W]
            owned = and_fold(xp.reshape(k, k, Bp // k, W))  # [chunk, Bp/k, W]
            out = owned.reshape(Bp, W)[:B]  # the all-gather: chunks in shard order
        else:
            recv = torch.empty_like(xp)
            dist.all_to_all_single(recv, xp.contiguous(), group=axis)
            owned = and_fold(recv.reshape(k, Bp // k, W))
            out = _all_gather(owned, axis)[:B]

    else:  # pmin: AND of bits == min of bits, one lane per attribute
        m = n_attrs if n_attrs is not None else W * 32
        bits = unpack_lanes(x, m)
        if sim:
            bits = bits.amin(0)
        else:
            bits = bits.contiguous()
            dist.all_reduce(bits, op=dist.ReduceOp.MIN, group=axis)
        out = pack_lanes(bits, W)

    return out.expand(k, B, W) if sim else out


def all_gather_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """Every shard's ``[n, ...]`` block stacked in shard order, ``[k·n,
    ...]`` (the reference's tiled ``lax.all_gather`` along axis 0).  On the
    simulated axis ``x`` is ``[k, n, ...]`` and the result carries the
    shard dimension, ``[k, k·n, ...]`` (an expanded view)."""
    if _is_simulated(axis):
        k = x.shape[0]
        flat = x.reshape(k * x.shape[1], *x.shape[2:])
        return flat.expand(k, *flat.shape)
    if dist.get_world_size(axis) == 1:
        return x
    return _all_gather(x, axis)


def all_gather_blocks(x: torch.Tensor, cand_group) -> torch.Tensor:
    """The candidate-axis survivor gather of a 2-D round: this rank's
    block stack ``[1, ...]`` (front-packed survivors, or their ``[1]``
    count) gathered over ``cand_group`` into ``[cand_parts, ...]`` in
    block order — the candidate group's rank order."""
    if dist.get_world_size(cand_group) == 1:
        return x
    return _all_gather(x, cand_group)


def sum_allreduce(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of the shards' supports ``[B]`` (the reference's ``psum``)."""
    if _is_simulated(axis):
        return x.sum(0, dtype=x.dtype).expand(x.shape)
    if dist.get_world_size(axis) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis)
    return out


def modeled_comm_bytes(
    impl: str, n_parts: int, batch: int, W: int, n_attrs: int | None = None
) -> int:
    """Analytic wire bytes for one reduce round over all ``n_parts`` shards.

    ``n_attrs`` bounds the pmin lane count exactly as it bounds the
    implementation (without it the full ``W·32`` unpacked width is charged).
    """
    if n_parts <= 1:
        return 0
    word_bytes = batch * W * 4
    if impl == "allgather":
        return n_parts * (n_parts - 1) * word_bytes
    if impl == "rsag":
        return int(2 * (n_parts - 1) * word_bytes)  # ring RS + AG, summed
    if impl == "pmin":
        lanes = n_attrs if n_attrs is not None else W * 32
        return n_parts * (n_parts - 1) * batch * lanes * 4
    raise ValueError(f"unknown reduce impl {impl!r}; choose {IMPLS}")


def ring_steps(impl: str, n_parts: int) -> int:
    """Per-device ring-step (latency hop) count for one reduce round:
    one ring pass (k-1) for allgather/pmin, two (2(k-1)) for rsag."""
    if impl not in IMPLS:
        raise ValueError(f"unknown reduce impl {impl!r}; choose {IMPLS}")
    if n_parts <= 1:
        return 0
    k = n_parts
    return 2 * (k - 1) if impl == "rsag" else k - 1


def modeled_cost_bytes(
    impl: str,
    n_parts: int,
    batch: int,
    W: int,
    n_attrs: int | None = None,
    *,
    hop_bytes: int = 4096,
) -> int:
    """α-β reduce-cost model in byte units: wire volume + per-hop latency
    (``hop_bytes`` per ring step per device) — what ``resolve_impl``
    minimizes for ``reduce_impl="auto"``."""
    if n_parts <= 1:
        return 0
    return modeled_comm_bytes(impl, n_parts, batch, W, n_attrs) + (
        n_parts * ring_steps(impl, n_parts) * hop_bytes
    )
