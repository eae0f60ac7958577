"""ConceptStore — the mined lattice as a device-resident, queryable artifact.

The store owns one :class:`repro_torch.dist.ShardPlan` (normally the same
plan that mined the intents) and keeps two kinds of state:

  * **object-sharded** — the packed context rows (``plan.place_rows``, the
    engine's placement) and the extent table ``ext_cols``: word ``wc`` of
    object ``g`` packs membership bits "g ∈ extent(c)" for concepts
    ``c ∈ [32·wc, 32·wc+32)``; ``[k, N/k, Wc]`` on a simulated plan, this
    rank's ``[N/k, Wc]`` on a group.  Extent queries run over these shards
    (one collective per batch).
  * **replicated snapshot** — a :class:`Snapshot`: the intent table in
    canonical index order, supports, the two-level hash index
    (head-attr × popcount, :mod:`repro_torch.core.hashindex`) flattened to a
    sorted key array for ``searchsorted`` bucket probes, and the packed
    order tables (sub/superconcept sets + the covering relation)
    materialized by the subset-test matmul of
    :mod:`repro_torch.core.lattice`'s device twin below.

Snapshots are immutable and double-buffered:
:class:`repro_torch.query.stream.StreamUpdater` stages a successor while
queries keep serving the active one; ``commit()`` swaps a single
reference.  Concept ids are positions in the snapshot's canonical order
and are only meaningful together with ``snapshot.version``.  Bitsets are
int32 views of the uint32 words on the device and uint32 on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset, hashindex, incremental
from repro_torch.core.closure import batched_closure_np
from repro_torch.core.context import FormalContext
from repro_torch.device import pack_lanes, resolve_device, unpack_lanes
from repro_torch.dist import collectives
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.kernels.ops import bucket_size

# Concepts per SPMD region of the extent build and the support recount:
# bounds the [.., N/k, B] subset matrix of one region.
CONCEPT_CHUNK = 4096


# ---------------------------------------------------------------------------
# device primitives (torch twins of the host index/lattice machinery)
# ---------------------------------------------------------------------------


def popcount_torch(x: torch.Tensor) -> torch.Tensor:
    """Per-set popcount of packed ``[..., W]`` int32 sets → int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.sum(-1).to(torch.int32)


def pack_bool_torch(dense: torch.Tensor) -> torch.Tensor:
    """Pack a bool tensor ``[..., 32·Wc]`` into ``[..., Wc]`` int32 words
    (device twin of ``bitset.pack_bool``; the last dim must already be a
    multiple of 32)."""
    return pack_lanes(dense, dense.shape[-1] // 32)


def order_tables(intents: torch.Tensor, n_concepts: int, *, n_attrs: int):
    """Subset-test matmul → packed order tables, all on the device.

    ``leq[i, j] = intent_i ⊆ intent_j`` via one popcount matmul over the
    unpacked bit-planes; the covering relation is the transitive reduction
    ``strict & ~(strict ∘ strict)`` (second matmul) — the device twin of
    ``repro_torch.core.lattice.subset_matrix`` / ``covering_matmul``.  Both
    products are float32 over {0, 1} with integer results far below 2²⁴,
    so they are exact (and stay ``torch.matmul``, as the reference left
    them to XLA).

    Returns ``(sub_rows, sup_rows, children_rows, parents_rows)``, each
    ``[Cb, Wc]`` int32 with ``Wc = Cb/32``: row ``c`` packs, over concept
    ids ``d``, the strict subconcepts of ``c`` (``intent_c ⊂ intent_d``),
    its strict superconcepts, the concepts ``c`` covers (the
    ``ConceptLattice.children`` convention: ``d``'s intent ⊂ ``c``'s with
    nothing between) and the concepts covering ``c``.
    """
    Cb = intents.shape[0]
    bits = unpack_lanes(intents, n_attrs).to(torch.float32)
    sizes = bits.sum(1)
    inter = bits @ bits.T  # [Cb, Cb] — |y_i ∩ y_j|
    valid = torch.arange(Cb, device=intents.device) < n_concepts
    leq = (inter == sizes[:, None]) & valid[:, None] & valid[None, :]
    strict = leq & ~torch.eye(Cb, dtype=torch.bool, device=intents.device)
    s = strict.to(torch.float32)
    via = (s @ s) > 0
    cover = strict & ~via  # cover[d, c]: d ∈ children[c]
    return (
        pack_bool_torch(strict),  # row c: {d : intent_c ⊂ intent_d}
        pack_bool_torch(strict.T),  # row c: {d : intent_d ⊂ intent_c}
        pack_bool_torch(cover.T),
        pack_bool_torch(cover),
    )


def lookup_ids(
    queries: torch.Tensor,
    intents: torch.Tensor,
    skeys: torch.Tensor,
    n_concepts: int,
    *,
    n_attrs: int,
    probe: int,
) -> torch.Tensor:
    """Two-level-hash concept lookup for a batch of (closed) intents.

    Level-1/level-2 keys (head attribute, popcount) flatten to
    ``hashindex.bucket_key``; the snapshot's intent table is sorted by that
    key, so the bucket is one ``searchsorted`` plus a ``probe``-wide
    window scan (``probe`` ≥ the snapshot's widest bucket) — O(probe·W)
    per query instead of O(C·W).  Returns concept ids (int32), -1 for
    misses.
    """
    heads = hashindex.batch_heads_torch(queries)
    lengths = popcount_torch(queries)
    keys = hashindex.bucket_key(heads, lengths, n_attrs).to(skeys.dtype)
    lo = torch.searchsorted(skeys, keys, side="left")
    window = lo[:, None] + torch.arange(probe, device=queries.device)[None, :]
    safe = window.clamp(0, intents.shape[0] - 1)
    hit = (
        (window < n_concepts)
        & (skeys[safe] == keys[:, None])
        & (intents[safe] == queries[:, None, :]).all(-1)
    )
    return torch.where(hit, window, -1).max(1).values.to(torch.int32)


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable, device-resident lattice version.

    Replicated tensors are padded to ``cap`` (a power of two ≥ 32, so the
    packed order tables stay word-aligned); rows past ``n_concepts`` are
    padding every query masks by id.  ``ext_cols`` is the object-sharded
    extent table (see module docstring) riding with the snapshot because a
    staged update grows it together with the intent set.
    """

    version: int
    n_concepts: int
    cap: int
    max_bucket: int
    intents: torch.Tensor  # [cap, W] int32, canonical (bucket-key) order
    supports: torch.Tensor  # [cap] int32
    skeys: torch.Tensor  # [cap] int32, ascending; pads = int32 max
    sub_rows: torch.Tensor  # [cap, Wc]
    sup_rows: torch.Tensor  # [cap, Wc]
    children_rows: torch.Tensor  # [cap, Wc]
    parents_rows: torch.Tensor  # [cap, Wc]
    ext_cols: torch.Tensor  # object-sharded [k, N/k, Wc] (a group: [N/k, Wc])
    intents_np: np.ndarray  # [C, W] uint32 host copy (oracles, export)
    supports_np: np.ndarray  # [C]

    @property
    def probe(self) -> int:
        """Bucket-scan window for :func:`lookup_ids`."""
        return bucket_size(max(1, self.max_bucket), minimum=4)


def canonical_order(intents: np.ndarray, n_attrs: int) -> np.ndarray:
    """Sort permutation for the snapshot's canonical concept order:
    ascending two-level bucket key, packed words as the tiebreak."""
    heads = hashindex.batch_heads(intents)
    lengths = bitset.popcount(intents)
    keys = hashindex.bucket_key(heads, lengths, n_attrs)
    words = tuple(intents[:, w] for w in reversed(range(intents.shape[1])))
    return np.lexsort(words + (keys,))


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StoreState:
    """Everything one store version consists of: the context, its device
    placement, and the snapshot built against it.  Immutable — a commit
    swaps the store's single reference to one of these, so a concurrent
    query batch reads a consistent (rows, snapshot) pair no matter when
    the swap lands."""

    ctx: FormalContext
    rows: torch.Tensor
    n_pad: int
    N_padded: int
    snapshot: Snapshot | None


class ConceptStore:
    """Device-resident concept store over one ShardPlan.

    ``build`` places the context once (the mining engine's plan can be
    reused by passing it) and materializes the first snapshot; the store
    then serves :class:`repro_torch.query.engine.QueryEngine` reads and
    :class:`repro_torch.query.stream.StreamUpdater` writes.  ``device`` is
    CUDA unless the caller says so (a process-group plan fixes it).
    """

    def __init__(self, ctx: FormalContext, plan: ShardPlan | None = None, *,
                 device=None):
        self.plan = plan or ShardPlan.simulated(1)
        if self.plan.device is not None:
            if device is not None and torch.device(device) != self.plan.device:
                raise ValueError(
                    f"device={device!r} differs from the plan's device {self.plan.device}"
                )
            device = self.plan.device
        self.device = resolve_device(device)
        rows, n_pad = ctx.padded_rows(self.plan.row_alignment)
        self._state = StoreState(
            ctx=ctx,
            rows=self.place_rows(rows),
            n_pad=n_pad,
            N_padded=rows.shape[0],
            snapshot=None,
        )
        self._staged: StoreState | None = None

    def place_rows(self, rows: np.ndarray) -> torch.Tensor:
        """Padded context rows onto the store's device, sharded by the plan."""
        return self.plan.place_rows(rows, self.device)

    def replicate(self, arr) -> torch.Tensor:
        return self.plan.replicate(arr, self.device)

    # one consistent view per read — query batches grab this once
    @property
    def state(self) -> StoreState:
        return self._state

    @property
    def ctx(self) -> FormalContext:
        return self._state.ctx

    @property
    def rows(self) -> torch.Tensor:
        return self._state.rows

    @property
    def n_pad(self) -> int:
        return self._state.n_pad

    @property
    def N_padded(self) -> int:
        return self._state.N_padded

    @property
    def snapshot(self) -> Snapshot | None:
        return self._state.snapshot

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls,
        ctx: FormalContext,
        intents,
        *,
        plan: ShardPlan | None = None,
        min_support: int | None = None,
        device=None,
    ) -> "ConceptStore":
        """``min_support`` keeps only the frequent (iceberg) concepts — one
        SPMD support pass filters before the snapshot materializes."""
        store = cls(ctx, plan, device=device)
        arr = (
            incremental.as_intent_array(intents)
            if len(intents)
            else np.zeros((0, ctx.W), np.uint32)  # iceberg can mine nothing
        )
        arr = np.unique(arr, axis=0)
        if min_support is not None and arr.shape[0]:
            C = arr.shape[0]
            buf = np.full((bucket_size(C, minimum=8), ctx.W), 0xFFFFFFFF, np.uint32)
            buf[:C] = arr
            sups = store._supports_only(buf, store.rows, ctx.n_objects)
            arr = arr[sups[:C] >= int(min_support)]
        store._state = dataclasses.replace(
            store._state, snapshot=store.make_snapshot(arr, version=0)
        )
        return store

    def iceberg(self, min_support: int) -> "ConceptStore":
        """A new store over the same context/plan serving only the active
        snapshot's concepts with support ≥ ``min_support`` — the
        iceberg-filtered view (supports come from the snapshot; no
        recount decides membership)."""
        snap = self.snapshot
        if snap is None:
            raise RuntimeError("no active snapshot to filter")
        store = ConceptStore(self.ctx, self.plan, device=self.device)
        keep = snap.intents_np[snap.supports_np >= int(min_support)]
        store._state = dataclasses.replace(
            store._state,
            snapshot=store.make_snapshot(keep, version=snap.version),
        )
        return store

    def make_snapshot(
        self,
        intents_np: np.ndarray,
        *,
        version: int,
        rows_dev: torch.Tensor | None = None,
        ctx: FormalContext | None = None,
    ) -> Snapshot:
        """Materialize a snapshot for ``intents_np`` (distinct, unordered).

        ``rows_dev``/``ctx`` default to the store's active context; the
        stream updater passes the staged (grown) ones.  Extent columns and
        supports come from one mixed-out-spec plan-SPMD region per concept
        chunk (:meth:`_ext_supports` — the extent pack stays on the
        shards; padded context rows are masked by global row index, no pad
        correction needed); the order tables are two device matmuls
        (:func:`order_tables`).
        """
        ctx = ctx or self.ctx
        rows_dev = self.rows if rows_dev is None else rows_dev
        m, W = ctx.n_attrs, ctx.W

        perm = canonical_order(intents_np, m)
        arr = intents_np[perm]
        C = arr.shape[0]
        cap = bucket_size(C, minimum=32)
        heads = hashindex.batch_heads(arr)
        lengths = bitset.popcount(arr)
        keys = hashindex.bucket_key(heads, lengths, m).astype(np.int32)
        max_bucket = int(np.bincount(keys - keys.min()).max()) if C else 1

        buf = np.full((cap, W), 0xFFFFFFFF, np.uint32)
        buf[:C] = arr
        skeys = np.full((cap,), np.iinfo(np.int32).max, np.int32)
        skeys[:C] = keys

        intents_dev = self.replicate(buf)
        # Padded intents are all-ones: only padded (all-ones) context rows
        # could contain them, and those are masked by the global row index,
        # so pad concepts get zero columns and zero support.
        ext_cols, sup_buf = self._ext_supports(buf, rows_dev, ctx.n_objects)
        sub_rows, sup_rows, children_rows, parents_rows = order_tables(
            intents_dev, C, n_attrs=m
        )
        return Snapshot(
            version=version,
            n_concepts=C,
            cap=cap,
            max_bucket=max(1, max_bucket),
            intents=intents_dev,
            supports=self.replicate(sup_buf),
            skeys=self.replicate(skeys),
            sub_rows=sub_rows,
            sup_rows=sup_rows,
            children_rows=children_rows,
            parents_rows=parents_rows,
            ext_cols=ext_cols,
            intents_np=arr,
            supports_np=sup_buf[:C],
        )

    # -- device extent build + support recount (mixed out-spec regions) -----

    def _masked_subset(self, rows_local, cands, n_objects):
        """``sub[.., g, c] = intent_c ⊆ row_g`` for the shard body's rows,
        with the padded context rows masked out via the plan's global row
        index — the test both the extent build and the supports-only
        filter share.  One word at a time: no ``[.., N/k, B, W]``
        intermediate."""
        sub = None
        for w in range(cands.shape[1]):
            ok = (cands[:, w] & ~rows_local[..., w : w + 1]) == 0  # [.., N/k, B]
            sub = ok if sub is None else sub & ok
        real = self.plan.global_row_index(rows_local) < n_objects
        return sub & real[..., None]

    def _region(self, with_extents: bool):
        """One SPMD region over a concept chunk: the local subset matrix →
        (packed extent columns, staying object-sharded via ``out_shard``;
        supports, summed over the shards and replicated)."""
        axes = self.plan.reduce_axes

        def body(rows_local, cands, n_objects):
            sub = self._masked_subset(rows_local, cands, n_objects)
            supports = collectives.sum_allreduce(sub.sum(-2, dtype=torch.int32), axes)
            if not with_extents:
                return supports
            return pack_bool_torch(sub), supports

        if with_extents:
            return self.plan.spmd(body, n_rep=2, out_shard=(True, False))
        return self.plan.spmd(body, n_rep=2)

    def _supports_only(
        self, buf: np.ndarray, rows_dev: torch.Tensor, n_objects: int
    ) -> np.ndarray:
        """Support recount without the extent pack — the cheap pass for
        pre-snapshot filters (``build(min_support=...)``), where the
        extents of dropped concepts would be thrown away."""
        step_fn = self._region(with_extents=False)
        cap = buf.shape[0]
        step = min(cap, CONCEPT_CHUNK)
        parts = [
            step_fn(rows_dev, self.replicate(buf[lo : lo + step]), n_objects).cpu().numpy()
            for lo in range(0, cap, step)
        ]
        return np.concatenate(parts)

    def _ext_supports(
        self, buf: np.ndarray, rows_dev: torch.Tensor, n_objects: int
    ) -> tuple[torch.Tensor, np.ndarray]:
        """Extent columns + supports for a padded intent table ``buf``
        [cap, W] (cap a power of two ≥ 32; pad rows all-ones).  Chunks of
        ≤ 4096 concepts bound each region's subset matrix; the chunks'
        columns concatenate on the device in the plan's sharded layout."""
        step_fn = self._region(with_extents=True)
        cap = buf.shape[0]
        step = min(cap, CONCEPT_CHUNK)
        ext_parts, sup_parts = [], []
        for lo in range(0, cap, step):
            ext, sup = step_fn(rows_dev, self.replicate(buf[lo : lo + step]), n_objects)
            ext_parts.append(ext)
            sup_parts.append(sup.cpu().numpy())
        ext_cols = ext_parts[0] if len(ext_parts) == 1 else torch.cat(ext_parts, dim=-1)
        return ext_cols, np.concatenate(sup_parts)

    # -- double-buffered commit protocol -----------------------------------

    def stage(self, state: StoreState):
        """Install a staged successor; the active snapshot keeps serving."""
        self._staged = state

    def commit(self) -> Snapshot:
        """Atomically swap the staged state in (one reference assignment —
        an in-flight query batch finishes on whichever state it read)."""
        if self._staged is None:
            raise RuntimeError("no staged update to commit")
        self._state, self._staged = self._staged, None
        return self._state.snapshot

    # -- introspection ------------------------------------------------------

    def describe(self) -> dict:
        snap = self.snapshot
        return {
            "plan": self.plan.describe(),
            "objects": self.ctx.n_objects,
            "attrs": self.ctx.n_attrs,
            "version": None if snap is None else snap.version,
            "concepts": None if snap is None else snap.n_concepts,
            "cap": None if snap is None else snap.cap,
            "max_bucket": None if snap is None else snap.max_bucket,
        }


def host_supports(ctx: FormalContext, intents_np: np.ndarray) -> np.ndarray:
    """Host oracle for the SPMD support recount (tests)."""
    _, s = batched_closure_np(ctx.rows, intents_np, ctx.attr_mask())
    return s.astype(np.int32)
