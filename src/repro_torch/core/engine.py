"""The closure engine — the MapReduce substrate for the MR* miners.

The engine owns the *static data*: the object-partitioned context rows,
resident on the device across every round (Twister's defining feature),
and executes the paper's map/reduce round:

    map    : per-shard batched closure (K1 for ``backend="kernel"``, the
             plain oracle for ``backend="torch"``, complement-plane matrix
             products for ``backend="matmul"``)
    reduce : bitwise-AND all-reduce of the local closures across the
             object partition + the sum of supports   (paper Theorem 2)

Every round goes through the engine's :class:`repro_torch.dist.ShardPlan`,
whose ``spmd`` primitive runs the shard body over a simulated shard
dimension on one device or over a ``torch.distributed`` group, one shard
per rank — same body, same collectives, bit-identical arithmetic.

``spmd_step`` builds one round, optionally followed by a *post* stage
(canonicity, feasibility, dedupe, iceberg cut) that consumes the global
closures; ``spmd_step_fused`` builds the same rounds for the frontier
step variants out of the fused kernels: K2 (closure → support → driver
filter in one pass) on one shard, K3 → K4 on k > 1 (K4 folding the
simulated shards' partials itself; a process-group rank runs the
AND-allreduce between the two).  ``spmd_step_cand`` and
``spmd_step_cand_fused`` are their 2-D twins for plans whose candidate
axis is blocked (``ShardPlan.spmd_cand``): the same map and reduce per
candidate block, the filter block-local, the survivors gathered along
the candidate axis and merged.
Supports are corrected globally: all-ones padding rows match every
candidate, so ``supports -= n_pad`` after the sum.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.context import FormalContext
from repro_torch.device import device_bits, host_bits, resolve_device
from repro_torch.dist import collectives
from repro_torch.dist.shardplan import AUTO_IMPLS, ShardPlan
from repro_torch.kernels import frontier as fkern
from repro_torch.kernels import ops
from repro_torch.obs import StatsBase
from repro_torch.obs import trace as obs

BACKENDS = ("kernel", "torch", "matmul")


@dataclasses.dataclass
class EngineStats(StatsBase):
    """Per-run mining ledger, charged as the reference charges it."""

    closure_calls: int = 0
    closures_computed: int = 0
    modeled_comm_bytes: int = 0
    rounds: int = 0
    # host↔device traffic census (the frontier pipeline's whole point)
    h2d_transfers: int = 0
    h2d_bytes: int = 0
    d2h_transfers: int = 0
    d2h_bytes: int = 0
    # wall seconds the host spent enqueueing device work vs blocked waiting
    # on device results, the α/β split of the modeled reduce cost, and the
    # async rounds' census: speculative rounds dispatched, those that fell
    # back to a synchronous re-dispatch, and those discarded unread
    dispatch_s: float = 0.0
    host_blocked_s: float = 0.0
    modeled_dispatch_bytes: int = 0
    modeled_collective_bytes: int = 0
    spec_rounds: int = 0
    spec_fallbacks: int = 0
    spec_discarded: int = 0


class ClosureEngine:
    def __init__(
        self,
        ctx: FormalContext,
        *,
        plan: ShardPlan | None = None,
        n_parts: int | None = None,
        backend: str = "kernel",
        reduce_impl: str | None = None,
        block_n: int | None = None,
        max_batch: int | None = None,
        device=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose {BACKENDS}")
        # Geometry (n_parts) conflicts with an explicit plan and raises; the
        # scalar knobs (reduce_impl/block_n/max_batch) override the plan's
        # values when passed.
        if plan is None:
            plan = ShardPlan.simulated(n_parts or 1, reduce_impl=reduce_impl or "rsag")
        elif n_parts is not None:
            raise ValueError("pass either plan= or the n_parts= geometry, not both")
        overrides = {
            k: v
            for k, v in (
                ("reduce_impl", reduce_impl),
                ("block_n", block_n),
                ("max_batch", max_batch),
            )
            if v is not None
        }
        if overrides:
            plan = dataclasses.replace(plan, **overrides)
        if plan.device is not None:  # a process-group plan fixes the device
            if device is not None and torch.device(device) != plan.device:
                raise ValueError(
                    f"device={device!r} differs from the plan's device {plan.device}"
                )
            device = plan.device
        self.device = resolve_device(device)
        self.plan = plan
        self.ctx = ctx
        self.backend = backend
        self.reduce_impl = plan.reduce_impl
        self.block_n = plan.block_n
        self.max_batch = plan.max_batch
        self.n_parts = plan.n_parts
        self.stats = EngineStats(
            auto_hop_bytes=plan.auto_hop_bytes,
            hop_calibrated=plan.hop_calibrated,
        )

        # Pad rows so every shard is block-aligned: N % (k * block_n) == 0.
        rows, n_pad = ctx.padded_rows(plan.row_alignment)
        self.n_pad_rows = n_pad
        self.N_padded = rows.shape[0]
        self.mask = device_bits(ctx.attr_mask(), self.device)  # [W]
        self.rows = plan.place_rows(rows, self.device)
        # Guards the frontier's step cache (``DeviceFrontier``): frontiers are
        # built from the main thread and the admission dispatcher thread, and
        # two first-misses of one step would otherwise both build it.
        self._frontier_lock = threading.Lock()

        self._step = self.spmd_step(with_supports=True)

    # -- the one partitioned execution path ------------------------------------

    def _local_closure(self, rows_local, cands):
        """Per-shard map phase for the configured backend: masked local
        closures + raw local supports (the global pad is corrected after
        the support sum)."""
        n_local = rows_local.shape[-2]
        if self.backend == "matmul":
            return ops.closure_matmul(
                rows_local, cands, self.ctx.n_attrs, n_valid_rows=n_local
            )
        return ops.batched_closure(
            rows_local,
            cands,
            self.ctx.n_attrs,
            n_valid_rows=n_local,
            use_kernel=self.backend == "kernel",
            mask=self.mask,
        )

    def _dispatch(self, make, *, per_block: bool = False):
        """One step per schedule: the fixed one, or — for ``auto`` — every
        schedule of ``AUTO_IMPLS``, resolved per round from the padded
        batch size, or on a 2-D step (``per_block``) from the block's
        (every schedule is bit-identical, so the choice only moves wire
        cost; ``charge_round`` / ``charge_round_cand`` ledger the same
        choice)."""
        plan, ctx = self.plan, self.ctx
        if plan.reduce_impl != "auto":
            return make(plan.reduce_impl)
        steps = {impl: make(impl) for impl in AUTO_IMPLS}
        parts = plan.cand_parts if per_block else 1

        def dispatch(rows, cands, *extras):
            impl = plan.resolve_impl(cands.shape[0] // parts, ctx.W, ctx.n_attrs)
            return steps[impl](rows, cands, *extras)

        return dispatch

    def spmd_step(self, post=None, *, with_supports: bool = False, n_extra: int = 0):
        """Build one plan round: map → AND-allreduce [→ post].

        The returned callable is ``step(rows, cands, *extras)``.  Each
        shard computes local closures, the reduce runs the plan's
        collective schedule, and — when given — ``post`` consumes the
        *global* closures (masked to real attributes), plus pad-corrected
        supports when ``with_supports``, plus the ``n_extra`` replicated
        extras.  Without ``post`` the step returns the masked global
        closures, plus the supports when ``with_supports``.
        """
        axes = self.plan.reduce_axes
        n_attrs, mask, n_pad = self.ctx.n_attrs, self.mask, self.n_pad_rows

        def make(impl):
            def body(rows_local, cands):
                lc, ls = self._local_closure(rows_local, cands)
                gc = collectives.and_allreduce(lc, axes, impl=impl, n_attrs=n_attrs) & mask
                if with_supports:
                    return gc, collectives.sum_allreduce(ls, axes) - n_pad
                return gc

            run = self.plan.spmd(body, n_rep=1, post=post, n_post_rep=n_extra)

            def step(rows, cands, *extras):
                if len(extras) != (n_extra if post is not None else 0):
                    raise TypeError(
                        f"step takes {n_extra} extra operands, got {len(extras)}"
                    )
                return run(rows, cands, *extras)

            return step

        return self._dispatch(make)

    def spmd_step_cand(
        self,
        post,
        merge,
        *,
        with_supports: bool = False,
        n_cand: int = 1,
        n_post_rep: int = 0,
        n_merge_rep: int = 0,
    ):
        """2-D twin of :meth:`spmd_step` for candidate-blocked chunks.

        The returned callable is ``step(rows, *cand_ops, *extras)``: the
        ``n_cand`` candidate operands (seeds first, then lineage such as
        parents and generators) are blocked over the plan's candidate
        axis; each block runs map → AND-allreduce over the *object* shards,
        ``post(idx, gc[, gs], *lineage, *extras)`` filters block-locally on
        ``[nb, Bc, ...]`` stacks, and only then are the survivors gathered
        along the candidate axis and handed to ``merge``.
        """
        axes = self.plan.reduce_axes
        n_attrs, mask, n_pad = self.ctx.n_attrs, self.mask, self.n_pad_rows

        def make(impl):
            def body(rows_local, cands, *lineage):
                lc, ls = self._local_closure(rows_local, cands)
                gc = collectives.and_allreduce(lc, axes, impl=impl, n_attrs=n_attrs) & mask
                if with_supports:
                    return gc, collectives.sum_allreduce(ls, axes) - n_pad
                return gc

            return self.plan.spmd_cand(
                body, n_cand=n_cand, post=post, n_post_rep=n_post_rep,
                merge=merge, n_merge_rep=n_merge_rep,
            )

        return self._dispatch(make, per_block=True)

    # -- fused-kernel step builders (backend="kernel") -------------------------
    #
    # Two placements, chosen by plan geometry:
    #
    #   n_parts == 1 — the local closure IS the global closure, so K2
    #     computes closure → support → driver filter in one pass; no
    #     collective runs (the size-1 AND-allreduce is the identity).
    #   n_parts > 1 — the filter needs the *global* closure, the AND of the
    #     shards' local closures, so the round is K3 (the attribute mask
    #     folded in: masked locals AND-reduce to the masked global) → K4.
    #     On a simulated plan K4 takes K3's [K, B, W] / [K, B] partials and
    #     does the AND over the shards and the support sum itself: on one
    #     card that fold is the AND-allreduce, bit for bit under every
    #     schedule (the census stays analytic, ``charge_round``, and
    #     ``collectives.folded_allreduce`` tells an audit's recorder of the
    #     fold).  On a process group each rank runs the plan's collectives
    #     between K3 and K4, which then takes the reduced operands at K = 1.
    #
    # Survivor compaction stays in torch and consumes only the keep mask:
    # identical masks in, identical order out, which is what makes the
    # fused steps bit-identical to the ``spmd_step`` + post builders.  Call
    # signatures match those builders, so DeviceFrontier routes by name
    # alone.

    def _fused_kernels(self, variant: str, LOW: torch.Tensor, wrap, *, per_block: bool = False):
        """``wrap(run)`` around the kernels of ``variant``'s fused round,
        ``run(rows, cands, scalars, parent=, gens=) -> (closures, keep)``:
        K2 on one object shard, else K3 → K4 (on a process group with the
        plan's collectives between them, one ``run`` per schedule)."""
        iceberg, cbo, _ = fkern.VARIANTS[variant]
        plan, ctx = self.plan, self.ctx
        mask = self.mask[None, :]

        if plan.n_parts == 1:

            def k2(rows, cands, sc, parent=None, gens=None):
                # one shard: a simulated [1, N, W] or a group rank's [N, W]
                kw = {"parent": parent, "lowrow": LOW[gens.long()]} if cbo else {}
                gc, _, keep = fkern.fused_step(rows.reshape(-1, ctx.W), cands, mask, sc,
                                               iceberg=iceberg, cbo=cbo, **kw)
                return gc, keep

            return wrap(k2)

        def k3_k4(reduce):
            def run(rows, cands, sc, parent=None, gens=None):
                lc, ls = reduce(*fkern.map_closure(rows, cands, mask))
                kw = {"parent": parent, "LOW": LOW, "gens": gens} if cbo else {}
                gc, _, keep = fkern.filter_step(lc, ls if iceberg else None, sc,
                                                iceberg=iceberg, cbo=cbo, **kw)
                return gc, keep

            return wrap(run)

        axes = plan.reduce_axes

        def make(impl):
            if plan.is_simulated:  # K4 folds the shards' partials

                def reduce(lc, ls):
                    return collectives.folded_allreduce(lc, ls if iceberg else None, axes,
                                                        impl=impl, n_attrs=ctx.n_attrs)

            else:

                def reduce(lc, ls):
                    gc = collectives.and_allreduce(lc, axes, impl=impl, n_attrs=ctx.n_attrs)
                    return gc.contiguous(), collectives.sum_allreduce(ls, axes) if iceberg else None

            return k3_k4(reduce)

        return self._dispatch(make, per_block=per_block)

    def spmd_step_fused(self, variant: str, LOW: torch.Tensor):
        """Fused-kernel step for ``variant`` ∈ ``fkern.VARIANTS``."""
        from repro_torch.core.frontier import _compact, _sort_unique

        iceberg, cbo, unique = fkern.VARIANTS[variant]
        n_pad = self.n_pad_rows

        def step_for(run):
            """The variant's step around ``run(rows, cands, scalars,
            parent=, gens=) -> (closures, keep)``."""
            def scalars(n_valid, ms):
                return fkern.pack_scalars(n_valid, ms[0] if iceberg else 0, n_pad, 0)

            if variant == "plain":

                def plain(rows, cands):
                    return run(rows, cands, scalars(0, ()))[0]

                return plain

            if cbo:

                def cbo_step(rows, cands, parents, gens, n_valid, *ms):
                    gc, keep = run(rows, cands, scalars(n_valid, ms), parent=parents, gens=gens)
                    n, gc, gens = _compact(keep, gc, gens)
                    return gc, gens, n

                return cbo_step

            def filter_step(rows, cands, n_valid, *ms):
                gc, keep = run(rows, cands, scalars(n_valid, ms))
                n, gc = _sort_unique(gc, keep) if unique else _compact(keep, gc)
                return gc, n

            return filter_step

        return self._fused_kernels(variant, LOW, step_for)

    def spmd_step_cand_fused(self, variant: str, LOW: torch.Tensor, merge,
                             *, n_merge_rep: int = 0):
        """Fused-kernel 2-D twin of :meth:`spmd_step_fused`: ``variant``'s
        keep test in the kernels, block-local compaction, survivors
        gathered along the candidate axis into ``merge``.

        A simulated plan launches once per chunk: K2 (one object shard), or
        K3 then K4 folding the partials (k shards), over the whole
        ``[cand_parts · Bc]`` chunk at ``row_off = 0`` — every keep test is
        row-wise, so this is what ``cand_parts`` launches at ``row_off =
        c · Bc`` compute.  A process-group rank closes its own block and
        launches at ``row_off = cand_index · Bc``, K4 at K = 1 after the
        object-subgroup reduce.  The compaction (and dedupe) then runs on
        the ``[nb, Bc]`` block views in torch.
        """
        from repro_torch.core.frontier import _compact_blocks, _sort_unique_blocks

        iceberg, cbo, unique = fkern.VARIANTS[variant]
        plan, n_pad = self.plan, self.n_pad_rows

        def scalars(cands, n_valid, ms):
            row_off = plan.cand_index() * cands.shape[0]
            return fkern.pack_scalars(n_valid, ms[0] if iceberg else 0, n_pad, row_off)

        def build(run):
            """The variant's 2-D step around ``run(rows, cands, scalars,
            parent=, gens=) -> (closures, keep)``; a simulated plan's
            outputs gain the length-1 shard dimension spmd_cand keeps."""
            lead = (lambda x: x[None]) if plan.is_simulated else (lambda x: x)

            if variant == "plain":

                def body(rows, cands):
                    return lead(run(rows, cands, scalars(cands, 0, ()))[0])

                return plan.spmd_cand(body, n_cand=1, merge=merge, n_merge_rep=n_merge_rep)

            if cbo:

                def body(rows, cands, parents, gens, n_valid, *ms):
                    gc, keep = run(rows, cands, scalars(cands, n_valid, ms),
                                   parent=parents, gens=gens)
                    return lead(gc), lead(keep)

                def post(idx, gc, keep, parents, gens):
                    n, gc, gens = _compact_blocks(keep, gc, gens)
                    return gc, gens, n

                return plan.spmd_cand(body, n_cand=3, n_rep=2 if iceberg else 1, post=post,
                                      merge=merge, n_merge_rep=n_merge_rep)

            def body(rows, cands, n_valid, *ms):
                gc, keep = run(rows, cands, scalars(cands, n_valid, ms))
                return lead(gc), lead(keep)

            def post(idx, gc, keep):
                n, gc = _sort_unique_blocks(gc, keep) if unique else _compact_blocks(keep, gc)
                return gc, n

            return plan.spmd_cand(body, n_cand=1, n_rep=2 if iceberg else 1, post=post,
                                  merge=merge, n_merge_rep=n_merge_rep)

        return self._fused_kernels(variant, LOW, build, per_block=True)

    # -- stats accounting -------------------------------------------------------

    def charge_round(self, cap: int, n_valid: int, *, count_round: bool = True):
        """Ledger one closure dispatch of a ``cap``-padded batch."""
        self.stats.closure_calls += 1
        if count_round:
            self.stats.rounds += 1
        self.stats.closures_computed += n_valid
        hops, vol = self.plan.modeled_latency_split(
            cap, self.ctx.W, self.ctx.n_attrs
        )
        self.stats.modeled_comm_bytes += vol
        self.stats.modeled_dispatch_bytes += hops
        self.stats.modeled_collective_bytes += vol
        impl = self.plan.resolve_impl(cap, self.ctx.W, self.ctx.n_attrs)
        self.stats.record_reduce(impl)

    def charge_round_cand(self, block_cap: int, n_valid: int, *, count_round: bool = True):
        """Ledger one 2-D dispatch: ``cand_parts`` blocks of ``block_cap``
        candidates each (the object reduce per block plus the candidate-axis
        survivor gather, ``ShardPlan.modeled_latency_split_cand``), the
        ``auto`` schedule resolved per block."""
        self.stats.closure_calls += 1
        if count_round:
            self.stats.rounds += 1
        self.stats.closures_computed += n_valid
        hops, vol = self.plan.modeled_latency_split_cand(
            block_cap, self.ctx.W, self.ctx.n_attrs
        )
        self.stats.modeled_comm_bytes += vol
        self.stats.modeled_dispatch_bytes += hops
        self.stats.modeled_collective_bytes += vol
        impl = self.plan.resolve_impl(block_cap, self.ctx.W, self.ctx.n_attrs)
        self.stats.record_reduce(impl)

    # -- public API ---------------------------------------------------------------

    @property
    def min_bucket(self) -> int:
        return max(8, self.n_parts)

    def closure(self, cands: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global closures + supports for a host candidate batch [B, W]."""
        B = cands.shape[0]
        W = self.ctx.W
        if B == 0:
            return np.zeros((0, W), np.uint32), np.zeros((0,), np.int32)
        out_c = np.empty((B, W), np.uint32)
        out_s = np.empty((B,), np.int32)
        self.stats.rounds += 1
        with obs.current().span("engine/closure", batch=B):
            for lo in range(0, B, self.max_batch):
                chunk = cands[lo : lo + self.max_batch]
                b = chunk.shape[0]
                cap = ops.bucket_size(b, minimum=self.min_bucket)
                if cap != b:  # pad with all-ones candidates; outputs dropped
                    pad = np.full((cap - b, W), 0xFFFFFFFF, np.uint32)
                    chunk = np.concatenate([chunk, pad], axis=0)
                gc, gs = self._step(self.rows, device_bits(chunk, self.device))
                out_c[lo : lo + b] = host_bits(gc)[:b]
                out_s[lo : lo + b] = gs.cpu().numpy()[:b]
                self.charge_round(cap, b, count_round=False)
                self.stats.h2d_transfers += 1
                self.stats.h2d_bytes += cap * W * 4
                self.stats.d2h_transfers += 2
                self.stats.d2h_bytes += cap * (W + 1) * 4
        return out_c, out_s

    def closure_dev(self, cands: torch.Tensor, n_valid: int, *, count_round: bool = True):
        """Device-to-device closure for an already bucket-padded batch.

        ``cands`` is a device tensor [cap, W]; rows past ``n_valid`` are
        padding whose outputs the caller ignores.  Nothing crosses the
        host boundary.
        """
        cap = cands.shape[0]
        gc, gs = self._step(self.rows, cands)
        self.charge_round(cap, n_valid, count_round=count_round)
        return gc, gs

    def first_closure(self) -> tuple[np.ndarray, int]:
        """``∅''`` and its support ``|O|`` via a full map/reduce round."""
        empty = np.zeros((1, self.ctx.W), np.uint32)
        c, s = self.closure(empty)
        return c[0], int(s[0])

