"""The closure engine — the MapReduce substrate for the MR* miners.

The engine owns the *static data*: the padded context rows, resident on
the device across every round (Twister's defining feature), and executes
the paper's map/reduce round:

    map    : batched closure of a candidate block against the rows
             (K1 for ``backend="kernel"``, the plain oracle for
             ``backend="torch"``)
    reduce : the bitwise-AND all-reduce of local closures across object
             shards (paper Theorem 2) — the identity on one shard, which
             is the only geometry this slice runs

``spmd_step`` builds one round, optionally followed by a *post* stage
(canonicity, feasibility, dedupe, iceberg cut) that consumes the global
closures; ``spmd_step_fused`` builds the same rounds for the frontier
step variants out of K2, which computes closure → support → driver filter
in one pass.  Supports are corrected globally: all-ones padding rows match
every candidate, so ``supports -= n_pad``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.context import FormalContext
from repro_torch.device import device_bits, host_bits, resolve_device
from repro_torch.dist.plan import ShardPlan
from repro_torch.kernels import frontier as fkern
from repro_torch.kernels import ops
from repro_torch.obs import StatsBase

BACKENDS = ("kernel", "torch")


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
    # on device results, and the α/β split of the modeled reduce cost
    dispatch_s: float = 0.0
    host_blocked_s: float = 0.0
    modeled_dispatch_bytes: int = 0
    modeled_collective_bytes: int = 0


class ClosureEngine:
    def __init__(
        self,
        ctx: FormalContext,
        *,
        backend: str = "kernel",
        device=None,
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; choose {BACKENDS}")
        plan = ShardPlan()  # one object shard: the geometry of this slice
        self.device = resolve_device(device)
        self.plan = plan
        self.ctx = ctx
        self.backend = backend
        self.block_n = plan.block_n
        self.max_batch = plan.max_batch
        self.n_parts = plan.n_parts
        self.stats = EngineStats(
            auto_hop_bytes=plan.auto_hop_bytes,
            hop_calibrated=plan.hop_calibrated,
        )

        rows, n_pad = ctx.padded_rows(plan.row_alignment)
        self.n_pad_rows = n_pad
        self.mask = device_bits(ctx.attr_mask(), self.device)  # [W]
        self.rows = plan.place_rows(rows, self.device)

        self._step = self.spmd_step(with_supports=True)

    # -- the one execution path ----------------------------------------------

    def _local_closure(self, rows_local, cands):
        """Map phase for the configured backend: masked closures + raw
        local supports (the global pad is corrected by the caller)."""
        return ops.batched_closure(
            rows_local,
            cands,
            self.ctx.n_attrs,
            n_valid_rows=rows_local.shape[0],
            block_n=self.block_n,
            use_kernel=self.backend == "kernel",
            mask=self.mask,
        )

    def spmd_step(self, post=None, *, with_supports: bool = False, n_extra: int = 0):
        """Build one round: map → AND-allreduce [→ post].

        The returned callable is ``step(rows, cands, *extras)``.  Without
        ``post`` it returns the masked global closures, plus pad-corrected
        supports when ``with_supports``; with ``post`` it returns
        ``post(gc[, gs], *extras)``.  ``n_extra`` is the number of extras
        ``post`` takes.
        """
        n_pad = self.n_pad_rows

        def step(rows, cands, *extras):
            if len(extras) != (n_extra if post is not None else 0):
                raise TypeError(f"step takes {n_extra} extra operands, got {len(extras)}")
            gc, ls = self._local_closure(rows, cands)
            # one shard: the AND-allreduce and the support sum are identities
            outs = (gc, ls - n_pad) if with_supports else (gc,)
            if post is None:
                return outs if with_supports else gc
            return post(*outs, *extras)

        return step

    # -- fused-kernel step builders (backend="kernel") -------------------------
    #
    # On one object shard the local closure IS the global closure, so K2
    # computes closure → support → driver filter in one pass.  Survivor
    # compaction stays in torch and consumes only the keep mask: identical
    # masks in, identical order out, which is what makes the fused steps
    # bit-identical to the ``spmd_step`` + post builders.  Call signatures
    # match those builders, so DeviceFrontier routes by name alone.

    def spmd_step_fused(self, variant: str, LOW: torch.Tensor):
        """K2 step for ``variant`` ∈ ``fkern.VARIANTS`` on one shard."""
        from repro_torch.core.frontier import _compact, _sort_unique

        iceberg, cbo, unique = fkern.VARIANTS[variant]
        mask = self.mask[None, :]
        n_pad = self.n_pad_rows

        if variant == "plain":

            def plain(rows, cands):
                gc, _, _ = fkern.fused_step(
                    rows, cands, mask, fkern.pack_scalars(0, 0, n_pad, 0)
                )
                return gc

            return plain

        if cbo:

            def cbo_step(rows, cands, parents, gens, n_valid, *ms):
                sc = fkern.pack_scalars(n_valid, ms[0] if iceberg else 0, n_pad, 0)
                gc, _, keep = fkern.fused_step(
                    rows, cands, mask, sc,
                    parent=parents, lowrow=LOW[gens.long()],
                    iceberg=iceberg, cbo=True,
                )
                n, gc, gens = _compact(keep, gc, gens)
                return gc, gens, n

            return cbo_step

        def filter_step(rows, cands, n_valid, *ms):
            sc = fkern.pack_scalars(n_valid, ms[0] if iceberg else 0, n_pad, 0)
            gc, _, keep = fkern.fused_step(rows, cands, mask, sc, iceberg=iceberg)
            n, gc = _sort_unique(gc, keep) if unique else _compact(keep, gc)
            return gc, n

        return filter_step

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

