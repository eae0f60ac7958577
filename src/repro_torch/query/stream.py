"""StreamUpdater — batched device-side Godin insertion with double-buffered
snapshots.

A batch of K new objects becomes a *staged* successor snapshot while the
active one keeps answering queries, then ``commit()`` swaps one reference.
The insertion is the device twin of the vectorized host path in
:mod:`repro_torch.core.incremental`:

    P          = subset intersections of the K new rows   (host fold — P is
                 bounded by the K-row subcontext's concept count, tiny)
    candidates = intents ∩ P                              (a device
                 broadcast-AND over the intent table, in chunks)
    grown set  = sort-unique(intents ∪ candidates ∪ P)    (the frontier
                 pipeline's lexsort + adjacent-unique dedupe,
                 ``repro_torch.core.frontier._sort_unique``, on device)

followed by one plan-SPMD support round over the grown context and the
two order-table matmuls (both inside ``ConceptStore.make_snapshot``).
``stage`` and ``commit`` record ``stream/stage`` and ``stream/commit``
spans on the current tracer; the staged wall ticks on the updater's
injectable ``clock``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import incremental
from repro_torch.core.context import FormalContext
from repro_torch.core.frontier import _sort_unique
from repro_torch.kernels.ops import bucket_size
from repro_torch.obs import trace as obs
from repro_torch.query.store import ConceptStore, StoreState

# Candidate rows (intents × P) per sort-unique pass of the grow step.
GROW_CHUNK_ROWS = 1 << 20


def _grow_intents_dev(
    intents: torch.Tensor, n_valid: int, P: torch.Tensor, n_p: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device Godin pass: ``sort-unique(intents ∪ (intents ∩ P) ∪ P)``.

    ``intents [Cb, W]`` and ``P [Pb, W]`` are bucket-padded (rows past
    ``n_valid`` / ``n_p`` are padding, excluded by the validity mask).
    The ``Cb·Pb`` intersections are built and deduplicated a chunk of
    intents at a time; the survivors of every chunk then go through one
    last sort-unique with the intents and P, which gives the same sorted
    distinct rows as one pass over everything.  Returns ``(buf, count)``
    with the distinct grown intents compacted to the front; the count
    stays on the device until the caller reads it.
    """
    Cb, W = intents.shape
    Pb = P.shape[0]
    dev = intents.device
    row_valid = torch.arange(Cb, device=dev) < n_valid
    p_valid = torch.arange(Pb, device=dev) < n_p
    parts, valids = [intents], [row_valid]
    step = max(1, GROW_CHUNK_ROWS // max(1, Pb))
    for lo in range(0, Cb, step):
        cand = (intents[lo : lo + step, None, :] & P[None, :, :]).reshape(-1, W)
        cand_valid = (row_valid[lo : lo + step, None] & p_valid[None, :]).reshape(-1)
        n, uniq = _sort_unique(cand, cand_valid)
        parts.append(uniq)
        valids.append(torch.arange(uniq.shape[0], device=dev) < n)
    parts.append(P)
    valids.append(p_valid)
    n, uniq = _sort_unique(torch.cat(parts), torch.cat(valids))
    return uniq, n


@dataclasses.dataclass
class UpdateReceipt:
    """What one staged batch did."""

    n_new_objects: int
    n_intersections: int  # |P|
    n_concepts_before: int
    n_concepts_after: int
    stage_wall_s: float
    version: int


class StreamUpdater:
    def __init__(self, store: ConceptStore, row_slack: int = 64, *, clock=time.perf_counter):
        self.store = store
        # the clock of the staged-wall measurement (a caller running a
        # virtual timebase passes its own)
        self.clock = clock
        # Round the grown context's row padding up to this quantum (kept a
        # multiple of the plan's row alignment), as the reference does so
        # its compiled steps see a new row count only once per ~row_slack
        # inserted objects.  Pad rows are the all-ones AND identity, masked
        # by count everywhere (supports, extents), so results are
        # bit-identical at any quantum; ``row_slack=0`` restores exact
        # alignment padding.
        align = store.plan.row_alignment
        self.row_quantum = max(align, ((row_slack + align - 1) // align) * align)

    def stage(self, new_rows: np.ndarray) -> UpdateReceipt:
        """Build the successor snapshot for ``new_rows [K, W]``.

        The active snapshot keeps serving throughout; nothing the query
        engine reads is mutated.  Call :meth:`commit` to swap.
        """
        store = self.store
        state = store.state  # one consistent (ctx, rows, snapshot) view
        t0 = self.clock()
        with obs.current().span("stream/stage") as sp:
            receipt = self._stage(store, state, new_rows, t0)
            sp.set(
                n_new_objects=receipt.n_new_objects,
                n_intersections=receipt.n_intersections,
                n_concepts_after=receipt.n_concepts_after,
                version=receipt.version,
            )
        return receipt

    def _stage(self, store, state, new_rows, t0) -> UpdateReceipt:
        snap, ctx = state.snapshot, state.ctx
        new_rows = np.ascontiguousarray(new_rows, dtype=np.uint32)
        if new_rows.ndim != 2 or new_rows.shape[1] != ctx.W:
            raise ValueError(f"new rows must be [K, {ctx.W}] packed uint32")
        if np.any(new_rows & ~ctx.attr_mask()):
            raise ValueError("new objects have attribute bits above n_attrs")

        # 1. subset intersections of the batch (host fold over tiny P)
        P = incremental.row_intersections(new_rows)

        # 2.+3. broadcast-AND + device sort-unique (frontier dedupe).
        # P pads are all-zero sets; ∅ can be a real intent, so the pad
        # rows are excluded by count, not by value.
        Pb = np.zeros((bucket_size(P.shape[0], minimum=4), ctx.W), np.uint32)
        Pb[: P.shape[0]] = P
        uniq, n_dev = _grow_intents_dev(
            snap.intents, snap.n_concepts, store.replicate(Pb), P.shape[0]
        )
        n_grown = int(n_dev)  # the commit's one scalar sync
        grown_np = np.array(uniq[:n_grown].cpu().numpy(), copy=True).view(np.uint32)

        # 4. grown context + placement, successor snapshot against it
        grown_ctx = FormalContext(
            rows=np.concatenate([ctx.rows, new_rows], axis=0),
            n_objects=ctx.n_objects + new_rows.shape[0],
            n_attrs=ctx.n_attrs,
            attr_names=ctx.attr_names,
        )
        rows_padded, n_pad = grown_ctx.padded_rows(self.row_quantum)
        rows_dev = store.place_rows(rows_padded)
        next_snap = store.make_snapshot(
            grown_np, version=snap.version + 1, rows_dev=rows_dev, ctx=grown_ctx
        )
        store.stage(
            StoreState(
                ctx=grown_ctx,
                rows=rows_dev,
                n_pad=n_pad,
                N_padded=rows_padded.shape[0],
                snapshot=next_snap,
            )
        )
        return UpdateReceipt(
            n_new_objects=new_rows.shape[0],
            n_intersections=P.shape[0],
            n_concepts_before=snap.n_concepts,
            n_concepts_after=next_snap.n_concepts,
            stage_wall_s=self.clock() - t0,
            version=next_snap.version,
        )

    def commit(self):
        """Swap the staged snapshot in (one reference assignment)."""
        with obs.current().span("stream/commit"):
            return self.store.commit()

    def apply(self, new_rows: np.ndarray) -> UpdateReceipt:
        """stage + commit in one call (the synchronous convenience path)."""
        receipt = self.stage(new_rows)
        self.commit()
        return receipt
