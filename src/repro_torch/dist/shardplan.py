"""ShardPlan — the partition-aware execution layer of the MR* rounds
(paper §3).

Every MR* round is the same program: per-shard local closure over the
object-partitioned context, then a bitwise-AND all-reduce (Theorem 2) plus
whatever per-round filter rides along (dedupe, canonicity, feasibility).
``ShardPlan`` owns

  * **partition geometry** — the object-axis shard count ``n_parts``, the
    block alignment ``block_n`` and the frontier-batch chunk cap
    ``max_batch``;
  * **placement** — ``place_rows`` shards the context, ``replicate`` puts
    frontier and table state on every shard;
  * **the collective schedule** — which AND-allreduce
    (``allgather`` / ``rsag`` / ``pmin``, :mod:`repro_torch.dist.collectives`)
    the reduce phase runs, and its analytic wire-byte model.  With
    ``reduce_impl="auto"``, ``resolve_impl`` picks allgather or rsag per
    round by the α-β cost of that round's padded batch.

Two kinds of plan run the same shard body:

  * **simulated** (:meth:`ShardPlan.simulated`) — k shards on one device
    as the leading dimension of ``[k, N/k, W]`` rows.  ``spmd`` runs the
    body once over the whole shard dimension (the kernels take it as a
    grid axis) and keeps shard 0's replicated outputs, as the reference's
    named ``vmap`` does;
  * **process group** (:meth:`ShardPlan.over_group`) — one shard per rank
    of a ``torch.distributed`` group.  Every rank runs the whole driver;
    the body sees this rank's ``[N/k, W]`` slice and the collectives run
    over the group, so every replicated output, and every survivor count
    the host loop branches on, is the same on every rank.

The AND semigroup is associative, commutative and idempotent over the
words, so both kinds and every schedule agree bit for bit.  ``spmd``'s
``out_shard=`` gives one region mixed output placement: object-sharded
outputs stay on their shards (the concept store's extent table), the
others reduce as usual.

The plan is 2-D capable: besides the object shards it can block the
*candidate* (frontier) axis over ``cand_parts`` blocks — the row-block ×
column-block decomposition.  ``spmd_cand`` is the 2-D primitive: the
AND-allreduce runs over the object shards at the block batch size, the
driver's filter runs block-locally, and only the filtered survivors are
all-gathered along the candidate axis.  On a simulated plan the blocks
live in one process: the body closes the whole chunk at once (every
closure, reduce and keep test is row-wise) and the block-local stages run
on ``[cand_parts, Bc, ...]`` views.  On a process group every rank holds
one object shard *and* one candidate block: the object reduce runs over
its object subgroup, the survivor gather over its candidate subgroup
(:mod:`repro_torch.launch.mesh` builds the two).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.dist import collectives
from repro_torch.dist.collectives import SIM_AXIS, SIM_CAND_AXIS
from repro_torch.dist.partition import object_axes

# Schedules the autotuner arbitrates between.  ``pmin`` is excluded: its
# unpacked-lane volume is strictly dominated for every batch size.
AUTO_IMPLS = ("allgather", "rsag")

# The process-group backend each device type runs on.  There is no
# fallback: a plan whose group does not match its device raises.
GROUP_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Partition geometry + placement + collective schedule for one run."""

    n_parts: int = 1
    reduce_impl: str = "rsag"
    block_n: int = 256
    max_batch: int = 8192
    cand_parts: int = 1
    # latency term of the "auto" schedule model: bandwidth-equivalent byte
    # cost of one ring step per device (collectives.modeled_cost_bytes).
    # The 4096 B default is replaced by a measured value when the plan is
    # built with ``calibrate_hops=True`` (see :func:`probe_hop_bytes`).
    auto_hop_bytes: int = 4096
    hop_calibrated: bool = False
    # process-group plans: the object group, the candidate group (2-D
    # plans), the device their collectives run on, and the mesh's axis
    # names and shape (major to minor) where the plan was built from one
    group: object = None
    cand_group: object = None
    device: torch.device | None = None
    axis_names: tuple[str, ...] = ()
    cand_axis_names: tuple[str, ...] = ()
    mesh_shape: tuple[tuple[str, int], ...] | None = None

    def __post_init__(self):
        if (
            self.reduce_impl != "auto"
            and self.reduce_impl not in collectives.IMPLS
        ):
            raise ValueError(
                f"unknown reduce schedule {self.reduce_impl!r}; "
                f"choose {collectives.IMPLS + ('auto',)}"
            )
        if self.n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {self.n_parts}")
        if self.cand_parts < 1:
            raise ValueError(
                f"cand_parts must be >= 1, got {self.cand_parts}"
            )
        if self.block_n < 1 or self.max_batch < 1:
            raise ValueError("block_n and max_batch must be >= 1")
        if self.group is not None and self.n_parts != dist.get_world_size(self.group):
            raise ValueError(
                f"n_parts ({self.n_parts}) does not match the group's size "
                f"({dist.get_world_size(self.group)})"
            )
        if self.group is not None:
            c = 1 if self.cand_group is None else dist.get_world_size(self.cand_group)
            if c != self.cand_parts:
                raise ValueError(
                    f"cand_parts ({self.cand_parts}) does not match the "
                    f"candidate group's size ({c})"
                )

    # -- constructors ------------------------------------------------------

    @classmethod
    def simulated(
        cls,
        n_parts: int = 1,
        *,
        cand_parts: int = 1,
        reduce_impl: str = "rsag",
        block_n: int = 256,
        max_batch: int = 8192,
        calibrate_hops: bool = False,
        device=None,
    ) -> "ShardPlan":
        """``n_parts`` object shards on one device (a leading shard
        dimension); ``cand_parts`` > 1 adds simulated candidate blocks.
        ``device`` is where a ``calibrate_hops`` probe runs (CUDA unless
        the caller says so)."""
        plan = cls(
            n_parts=n_parts,
            reduce_impl=reduce_impl,
            block_n=block_n,
            max_batch=max_batch,
            cand_parts=cand_parts,
        )
        return plan.calibrate_hops(device) if calibrate_hops else plan

    @classmethod
    def over_group(
        cls,
        group=None,
        device=None,
        *,
        cand_group=None,
        reduce_impl: str = "rsag",
        block_n: int = 256,
        max_batch: int = 8192,
        calibrate_hops: bool = False,
        axis_names: tuple[str, ...] = (),
        cand_axis_names: tuple[str, ...] = (),
        mesh_shape: tuple[tuple[str, int], ...] | None = None,
    ) -> "ShardPlan":
        """One object shard per rank of ``group`` (the default group when
        None), with collectives on ``device``: NCCL for a CUDA device,
        gloo only when the caller passes ``device="cpu"``.  ``cand_group``
        (2-D plans) is this rank's candidate subgroup: the ranks that hold
        the same object shard and the other candidate blocks."""
        if not dist.is_initialized():
            raise RuntimeError("over_group needs an initialized torch.distributed group")
        group = dist.group.WORLD if group is None else group
        device = resolve_device(device)
        want = GROUP_BACKENDS.get(device.type)
        for g in (group, cand_group):
            if g is not None and dist.get_backend(g) != want:
                raise ValueError(
                    f"a plan on {device.type} runs its collectives over {want!r}; "
                    f"the group's backend is {dist.get_backend(g)!r}"
                )
        cand_parts = 1 if cand_group is None else dist.get_world_size(cand_group)
        plan = cls(
            n_parts=dist.get_world_size(group),
            reduce_impl=reduce_impl,
            block_n=block_n,
            max_batch=max_batch,
            cand_parts=cand_parts,
            group=group,
            cand_group=cand_group if cand_parts > 1 else None,
            device=device,
            axis_names=tuple(axis_names),
            cand_axis_names=tuple(cand_axis_names) if cand_parts > 1 else (),
            mesh_shape=mesh_shape,
        )
        return plan.calibrate_hops() if calibrate_hops else plan

    @classmethod
    def over_mesh(cls, mesh, device=None, **kw) -> "ShardPlan":
        """The plan of a :class:`repro_torch.launch.mesh.GroupMesh`: this
        rank's object shard over the mesh's object subgroup, its candidate
        block over the candidate subgroup."""
        return cls.over_group(
            mesh.object_group,
            device,
            cand_group=mesh.cand_group,
            axis_names=object_axes(mesh),
            cand_axis_names=mesh.cand_axes,
            mesh_shape=mesh.shape,
            **kw,
        )

    @classmethod
    def auto(
        cls, n_parts: int = 8, *, reduce_impl: str = "rsag", device=None, **kw
    ) -> "ShardPlan":
        """A process-group plan over the default group when
        ``torch.distributed`` is initialized with more than one rank, else
        a simulated ``n_parts``-way plan on one device."""
        if dist.is_initialized() and dist.get_world_size() > 1:
            return cls.over_group(None, device, reduce_impl=reduce_impl, **kw)
        return cls.simulated(n_parts, reduce_impl=reduce_impl, device=device, **kw)

    def calibrate_hops(self, device=None) -> "ShardPlan":
        """This plan with ``auto_hop_bytes`` measured, not defaulted.

        Runs :func:`probe_hop_bytes` (one-shot per plan geometry, cached at
        module level).  ``hop_calibrated`` stays False when the probe hit
        its noise floor and fell back to the default — the stats never
        claim a measurement that did not happen.
        """
        hop, measured = probe_hop_bytes(self, device)
        return dataclasses.replace(
            self, auto_hop_bytes=hop, hop_calibrated=measured
        )

    # -- geometry ----------------------------------------------------------

    @property
    def is_simulated(self) -> bool:
        return self.group is None

    @property
    def reduce_axes(self):
        """The axis the shard body's collectives reduce over."""
        return SIM_AXIS if self.group is None else self.group

    @property
    def cand_axes(self):
        """The axis carrying the candidate partition (2-D plans only):
        :data:`SIM_CAND_AXIS` on a simulated plan, the candidate group on
        a process group; None on 1-D plans."""
        if self.cand_parts <= 1:
            return None
        return SIM_CAND_AXIS if self.group is None else self.cand_group

    @property
    def row_alignment(self) -> int:
        """Context rows must pad to a multiple of this (shards block-align)."""
        return self.n_parts * self.block_n

    def shard_index(self) -> int:
        """This process's shard (the group rank; 0 on a simulated plan,
        whose shards all live in one process)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    def cand_index(self) -> int:
        """This process's candidate block: its rank in the candidate group;
        0 on 1-D plans and on a simulated plan, whose blocks all live in one
        process (an ``spmd_cand`` body there sees the whole chunk, so
        ``cand_index() * Bc`` is the first row it holds either way)."""
        if self.cand_parts <= 1 or self.group is None:
            return 0
        return dist.get_rank(self.cand_group)

    def global_row_index(self, rows_local: torch.Tensor) -> torch.Tensor:
        """The global row index of every row an ``spmd`` body sees.

        Simulated plan (rows ``[k, N/k, W]``): ``[k, N/k]``, shard ``i``'s
        rows at ``i·N/k + arange(N/k)``.  Process-group plan (this rank's
        ``[N/k, W]``): ``[N/k]`` from the rank's offset.  A body that masks
        the padding rows by global index reads it here and never branches
        on the plan's kind; ``shard_index() * N/k`` would read every
        simulated shard as shard 0.
        """
        n_local = rows_local.shape[-2]
        local = torch.arange(n_local, device=rows_local.device)
        if self.group is None:
            k = rows_local.shape[0]
            return torch.arange(k, device=rows_local.device)[:, None] * n_local + local
        return self.shard_index() * n_local + local

    # -- placement ---------------------------------------------------------

    def place_rows(self, rows: np.ndarray, device) -> torch.Tensor:
        """Shard padded context rows ``[N, W]`` (uint32) onto ``device``.

        Simulated plan: ``[k, N/k, W]``.  Process-group plan: this rank's
        ``[N/k, W]`` slice.  Both are int32 views of the words.
        """
        if rows.shape[0] % self.n_parts:
            raise ValueError(
                f"rows ({rows.shape[0]}) not divisible by n_parts ({self.n_parts})"
            )
        n = rows.shape[0] // self.n_parts
        if self.group is None:
            local = rows.reshape(self.n_parts, n, *rows.shape[1:])
        else:
            i = self.shard_index()
            local = rows[i * n : (i + 1) * n]
        return self.replicate(local, device)

    def replicate(self, arr, device) -> torch.Tensor:
        """Dynamic per-round state (frontier, tables) on ``device``, whole
        on every shard: each rank of a group holds its own copy, so
        expansion and pruning run partition-locally.  uint32 words become
        their int32 view; other integer arrays keep their values."""
        a = np.asarray(arr)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    # -- execution ---------------------------------------------------------

    def spmd(
        self,
        body,
        *,
        n_rep: int,
        post=None,
        n_post_rep: int = 0,
        out_shard: tuple[bool, ...] | None = None,
    ):
        """Wrap ``body(rows_local, *replicated)`` for per-shard execution.

        The first argument is the object-sharded context; the following
        ``n_rep`` arguments are replicated.  ``body`` may call collectives
        over ``self.reduce_axes``; its outputs must be shard-invariant
        (globally reduced, or computed from replicated operands).

        Simulated plan: ``body`` runs once over the whole ``[k, N/k, W]``
        shard dimension, every output carries a leading shard dimension,
        and shard 0's copy is kept.  Process-group plan: ``body`` runs on
        this rank's slice and its outputs are already replicated.

        ``out_shard`` gives the region mixed output placement: one boolean
        per ``body`` output, True for an output that stays object-sharded
        (``[k, N/k, ...]`` on a simulated plan, the layout ``place_rows``
        produces; this rank's ``[N/k, ...]`` slice on a group), False for a
        shard-invariant one, reduced as above.  It cannot be combined with
        ``post``, which consumes shard-invariant inputs only.

        ``post(*body_outputs, *post_replicated)`` is an optional stage that
        consumes the shard-invariant outputs (canonicity, feasibility,
        dedupe); it runs once on a simulated plan and on every rank of a
        group.  The returned callable takes
        ``(rows, *replicated, *post_replicated)``.
        """
        if out_shard is not None and post is not None:
            raise ValueError("out_shard= and post= are mutually exclusive")
        simulated = self.group is None

        def run(rows, *rep):
            outs = body(rows, *rep[:n_rep])
            tup = isinstance(outs, tuple)
            if out_shard is not None:
                if not tup or len(outs) != len(out_shard):
                    raise ValueError(
                        f"out_shard has {len(out_shard)} entries for "
                        f"{len(outs) if tup else 1} body outputs"
                    )
                if not simulated:
                    return outs
                return tuple(o if s else o[0] for o, s in zip(outs, out_shard))
            if simulated:
                outs = tuple(o[0] for o in outs) if tup else outs[0]
            if post is None:
                return outs
            return post(*(outs if tup else (outs,)), *rep[n_rep:])

        return run

    def spmd_cand(
        self,
        body,
        *,
        n_cand: int = 1,
        n_rep: int = 0,
        post=None,
        n_post_rep: int = 0,
        merge=None,
        n_merge_rep: int = 0,
    ):
        """2-D (candidate × object) twin of :meth:`spmd`.

        The returned callable takes ``(rows, *cand_ops, *replicated,
        *post_replicated, *merge_replicated)``.  The first ``n_cand``
        operands after ``rows`` are the chunk's candidate operands (seeds
        first, then lineage such as parents and generators), whose leading
        axis — a multiple of ``cand_parts`` — is blocked over the candidate
        axis.  ``body(rows_local, *cand_ops, *replicated)`` computes the
        map and the object-axis reduce (collectives over ``reduce_axes``)
        and, as in :meth:`spmd`, its outputs carry the leading shard
        dimension on a simulated plan (a body that already folded the
        shards returns a length-1 one); shard 0's copy is kept.

        Simulated plan: the body runs once over the whole chunk (every
        operand it computes is row-wise in the candidates, so this is
        exactly what ``cand_parts`` block-sized runs would compute).  A
        process-group rank: the body sees its own block,
        ``cand_ops[i][cand_index()·Bc : (cand_index() + 1)·Bc]``.

        The body's outputs, followed by the lineage operands (``cand_ops[1:]``,
        which ride along as the reference's body passes them through), are
        viewed as blocks ``[nb, Bc, ...]`` — ``nb = cand_parts`` on a
        simulated plan, 1 on a rank — and handed to ``post(idx,
        *blocks, *post_replicated)``, the block-local filter, with ``idx``
        the ``[nb]`` block positions (int64, on the operands' device).
        ``post`` returns block stacks ``[nb, ...]`` (per-block counts are
        ``[nb]``).  Only then are the blocks all-gathered along the
        candidate axis into ``[cand_parts, ...]`` stacks (free on a
        simulated plan, an all-gather over the candidate group on a rank),
        which ``merge(*gathered, *merge_replicated)`` consumes, once per
        process.  At ``cand_parts == 1`` the stack has one block and the
        arithmetic is the 1-D path's.
        """
        cp = self.cand_parts
        split = n_cand + n_rep
        split_post = split + n_post_rep
        simulated = self.group is None

        def _tup(x):
            return x if isinstance(x, tuple) else (x,)

        def run(rows, *ops):
            if len(ops) != split_post + n_merge_rep:
                raise TypeError(
                    f"the step takes {split_post + n_merge_rep} operands after rows, "
                    f"got {len(ops)}"
                )
            cand = ops[:n_cand]
            ci = self.cand_index()
            if not simulated and cp > 1:  # this rank's block of the chunk
                cand = tuple(
                    op.reshape(cp, op.shape[0] // cp, *op.shape[1:])[ci] for op in cand
                )
            outs = _tup(body(rows, *cand, *ops[n_cand:split]))
            if simulated:
                outs = tuple(o[0] for o in outs)
            nb = cp if simulated else 1
            outs = tuple(
                o.reshape(nb, o.shape[0] // nb, *o.shape[1:]) for o in outs + cand[1:]
            )
            if post is not None:
                idx = torch.arange(nb, device=outs[0].device) + ci
                outs = _tup(post(idx, *outs, *ops[split:split_post]))
            if cp > 1:  # free on a simulated plan, whose blocks are already stacked
                outs = tuple(collectives.all_gather_blocks(o, self.cand_axes) for o in outs)
            if merge is None:
                return outs
            return merge(*outs, *ops[split_post:])

        return run

    # -- accounting --------------------------------------------------------

    def resolve_impl(
        self, batch: int, W: int, n_attrs: int | None = None
    ) -> str:
        """The schedule one reduce round of ``batch`` candidates runs.

        A fixed ``reduce_impl`` is returned as-is; ``"auto"`` picks the
        α-β-cheapest of :data:`AUTO_IMPLS` for this round's padded batch
        (allgather's single ring pass wins latency-bound small batches,
        rsag's 2(k-1)/k volume wins bandwidth-bound large ones).
        Deterministic in the batch size, so every rank of a group resolves
        the same schedule.
        """
        if self.reduce_impl != "auto":
            return self.reduce_impl
        return min(
            AUTO_IMPLS,
            key=lambda impl: collectives.modeled_cost_bytes(
                impl, self.n_parts, batch, W, n_attrs,
                hop_bytes=self.auto_hop_bytes,
            ),
        )

    def modeled_reduce_bytes(
        self, batch: int, W: int, n_attrs: int | None = None
    ) -> int:
        """Analytic wire bytes one reduce round of ``batch`` candidates
        costs under this plan's schedule."""
        return collectives.modeled_comm_bytes(
            self.resolve_impl(batch, W, n_attrs), self.n_parts, batch, W, n_attrs
        )

    def modeled_round_bytes_cand(
        self, block_batch: int, W: int, n_attrs: int | None = None
    ) -> int:
        """Analytic wire bytes for one 2-D round of ``cand_parts`` blocks
        of ``block_batch`` candidates each: ``cand_parts`` object-axis
        reduces at the block batch size, plus the survivor all-gather along
        the candidate axis (``n_parts`` rings of ``cand_parts`` devices,
        one allgather pass over the block-sized survivor buffer each)."""
        return self.modeled_latency_split_cand(block_batch, W, n_attrs)[1]

    def modeled_latency_split(
        self, batch: int, W: int, n_attrs: int | None = None
    ) -> tuple[int, int]:
        """``(dispatch_bytes, collective_bytes)`` — the α-β split of one
        reduce round's modeled cost: the per-hop latency
        (``n_parts × ring_steps × auto_hop_bytes``) and the wire volume
        (what :meth:`modeled_reduce_bytes` reports)."""
        impl = self.resolve_impl(batch, W, n_attrs)
        vol = collectives.modeled_comm_bytes(
            impl, self.n_parts, batch, W, n_attrs
        )
        hops = (
            self.n_parts
            * collectives.ring_steps(impl, self.n_parts)
            * self.auto_hop_bytes
        )
        return hops, vol

    def modeled_latency_split_cand(
        self, block_batch: int, W: int, n_attrs: int | None = None
    ) -> tuple[int, int]:
        """``(dispatch_bytes, collective_bytes)`` for one 2-D round: the
        volume of :meth:`modeled_round_bytes_cand`, and the hops of the two
        ring schedules — ``cand_parts`` object rings at the resolved
        schedule plus ``n_parts`` candidate-axis allgather rings — priced
        at ``auto_hop_bytes`` each."""
        impl = self.resolve_impl(block_batch, W, n_attrs)
        k, c = self.n_parts, self.cand_parts
        obj_vol = c * collectives.modeled_comm_bytes(impl, k, block_batch, W, n_attrs)
        gather_vol = k * c * (c - 1) * block_batch * W * 4
        obj_hops = c * k * collectives.ring_steps(impl, k) * self.auto_hop_bytes
        gather_hops = k * c * collectives.ring_steps("allgather", c) * self.auto_hop_bytes
        return obj_hops + gather_hops, obj_vol + gather_vol

    def describe(self) -> dict:
        """JSON-friendly summary for launcher output."""
        simulated = self.group is None
        return {
            "mode": "simulated" if simulated else "group",
            "n_parts": self.n_parts,
            "axes": [SIM_AXIS] if simulated else list(self.axis_names or ("rank",)),
            "backend": None if simulated else dist.get_backend(self.group),
            "cand_parts": self.cand_parts,
            "cand_axes": (
                ([SIM_CAND_AXIS] if self.cand_parts > 1 else [])
                if simulated
                else list(self.cand_axis_names)
            ),
            "mesh_shape": None if self.mesh_shape is None else dict(self.mesh_shape),
            "reduce_impl": self.reduce_impl,
            "block_n": self.block_n,
            "max_batch": self.max_batch,
            "auto_hop_bytes": self.auto_hop_bytes,
            "hop_calibrated": self.hop_calibrated,
        }

    def trace_tags(self) -> dict:
        """The geometry tags every round span carries (repro_torch.obs):
        the subset of :meth:`describe` that identifies the plan in a
        timeline."""
        return {
            "plan": "simulated" if self.group is None else "group",
            "n_parts": self.n_parts,
            "cand_parts": self.cand_parts,
            "reduce_impl": self.reduce_impl,
        }


# ---------------------------------------------------------------------------
# interconnect probe (auto_hop_bytes calibration)
# ---------------------------------------------------------------------------

# One-shot per plan geometry: plans with the same shard count over the same
# device (and, for a group, the same ranks) share a measurement; a value
# never leaks between geometries.  Values are (hop_bytes, measured);
# measured=False marks a noise-floor fallback to the default.
_HOP_PROBE_CACHE: dict[tuple, tuple[int, bool]] = {}

_PROBE_W = 4  # packed words per probe row — scale-free, cancels in the ratio


def _probe_cache_key(plan: ShardPlan, device: torch.device) -> tuple:
    """The plan geometry the probe measures: shard counts on both axes, the
    device, and for a group its backend, global ranks and mesh shape."""
    if plan.group is None:
        ranks = None
    else:
        ranks = (
            dist.get_backend(plan.group),
            tuple(dist.get_process_group_ranks(plan.group)),
            plan.mesh_shape,
        )
    return (plan.n_parts, plan.cand_parts, str(device), ranks)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_hop_bytes(plan: ShardPlan, device=None) -> tuple[int, bool]:
    """Measure the plan's per-ring-step latency as equivalent wire bytes.

    Times the plan's own allgather AND-reduce (the collective the "auto"
    schedule arbitrates) at a tiny and a large batch: ``t(B) ≈ α + β·B``
    separates the per-round fixed cost α from the per-row cost β, and the
    bandwidth-equivalent hop cost is ``hop_bytes = (α/β) · W · 4``.
    Best-of-3 timings.  On a process group every rank takes rank 0's
    result, so all ranks resolve the same schedules.  Returns
    ``(hop_bytes, measured)``; ``measured=False`` means the probe saw no
    per-byte slope (noise floor) and fell back to the 4096 B default.
    """
    device = plan.device if plan.group is not None else resolve_device(device)
    key = _probe_cache_key(plan, device)
    cached = _HOP_PROBE_CACHE.get(key)
    if cached is not None:
        return cached

    axes = plan.reduce_axes

    def body(rows_local, cands):
        lc = rows_local[..., :1, :] & cands  # touch the sharded operand
        return collectives.and_allreduce(
            lc, axes, impl="allgather", n_attrs=_PROBE_W * 32
        )

    fn = plan.spmd(body, n_rep=1)
    rows = plan.place_rows(
        np.full((plan.n_parts, _PROBE_W), 0xFFFFFFFF, np.uint32), device
    )

    def timed(batch: int) -> float:
        cands = torch.full((batch, _PROBE_W), -1, dtype=torch.int32, device=device)
        fn(rows, cands)  # warm
        _sync(device)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn(rows, cands)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        return best

    b_small, b_large = 8, 4096
    t_small, t_large = timed(b_small), timed(b_large)
    slope = t_large - t_small
    if slope <= 0:
        # Noise floor: the large batch measured no slower than the tiny
        # one, so the per-byte term is unobservable — keep the default.
        result = (4096, False)
    else:
        beta = slope / (b_large - b_small)
        alpha = max(t_small - beta * b_small, 0.0)
        # bound at 16 MiB: beyond that the "latency term" would just mean
        # the probe was swamped by noise
        hop = min(1 << 24, max(1, int(round(alpha / beta * _PROBE_W * 4))))
        result = (hop, True)
    if plan.group is not None:
        # every rank takes the value of the first object group's rank 0, so
        # every rank of a 2-D plan resolves the same schedules too
        agreed = torch.tensor([result[0], int(result[1])], dtype=torch.int64, device=device)
        dist.broadcast(agreed, src=dist.get_global_rank(plan.group, 0), group=plan.group)
        if plan.cand_group is not None:
            dist.broadcast(agreed, src=dist.get_global_rank(plan.cand_group, 0),
                           group=plan.cand_group)
        result = (int(agreed[0]), bool(agreed[1]))
    _HOP_PROBE_CACHE[key] = result
    return result
