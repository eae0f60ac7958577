"""Device-resident frontier pipeline for the MR* drivers.

The drivers' *frontier* (the intents of the previous iteration) lives on
the device.  Every iteration runs

    frontier [F, W]  ──►  vectorized seed expansion (LOW/BIT broadcast)
                     ──►  validity compaction (+ local pruning: unsigned
                          lexsort + adjacent-unique over packed words)
                     ──►  one engine round per chunk: closure map → the
                          driver's filter (canonicity / feasibility /
                          closure dedupe / iceberg min-support cut)
                     ──►  compacted survivors

and only the surviving closures and their counts cross to the host.

Rounds run in one of two modes.  Sync rounds (``step_*``) read each
round's survivor count on the host before the next round is sized.  Async
rounds (``spec_*`` / ``reconcile_*``) dispatch round r+1 against round r's
survivor buffer while its count is still on the device: the count chains
from kernel to kernel as a 0-dim int32 tensor (K2 and K4 read it there),
and each round's one readback — its counts and survivor rows packed in
one buffer — is copied into pinned host memory behind the round's kernels
on the compute stream, then waited on only when the mining loop reconciles the
round, by which time the next one is in flight.

On a 2-D plan (``ShardPlan.cand_parts > 1``) the chunk itself is blocked
over the candidate axis: each block is closed and reduced over the object
shards at the block batch size, the driver filter runs block-locally, and
the blocks' compacted survivors are gathered along the candidate axis and
merged (``merge_blocks_*``) — one round absorbs ``cand_parts × max_batch``
candidates.  MRGanter's single-intent walk stays 1-D.

Every host boundary of a round records a span on the current tracer
(:mod:`repro_torch.obs`): ``mine/round[r]`` tagged with the plan's
geometry, and inside it ``/expand``, ``/dispatch``, ``/allreduce`` (the
blocking read of the survivor count, which sizes the next step) and
``/filter`` (the survivor download).  An async round is an async track
``mine/round[r]`` (ended with ``outcome=adopt|fallback|discard``) around
the host spans ``spec/dispatch[r]`` and ``spec/reconcile[r]``.  Spans add
no device synchronisation of their own.

On ``backend="kernel"`` engines the step variants run the fused kernels — K2
(closure, support and filter in one pass) on one object shard, K3 →
AND-allreduce → K4 on k > 1; on the other backends they run the plain
round followed by the same filters as torch ops.  All give the same rows
in the same order.  Tables and frontier buffers are replicated through
the engine's plan, so on a process group every rank holds its own copy
and expands partition-locally.

Every sort that orders rows sorts on unsigned keys (``x ^ INT32_MIN`` on
the int32 view) and is stable, so the row order matches the reference's
uint32 order bit for bit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import lectic
from repro_torch.device import host_bits, unsigned_key
from repro_torch.kernels import frontier as fkern
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs

# ---------------------------------------------------------------------------
# device primitives
# ---------------------------------------------------------------------------


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _compact(valid: torch.Tensor, *arrays) -> tuple:
    """Stable-move rows with ``valid`` to the front of every array.

    Returns ``(count, *reordered_arrays)`` — shapes unchanged (rows past
    ``count`` are garbage the caller slices away after a scalar sync).
    """
    perm = _stable_order((~valid).to(torch.uint8))
    return (valid.sum(dtype=torch.int32), *(a[perm] for a in arrays))


def _unique_rows(seeds: torch.Tensor, valid: torch.Tensor, block=None):
    """Lexsort packed rows and mark the first of each run of equal rows.

    Keys, most significant first: ``block`` (when given), validity (invalid
    rows last), then word 0 down to word W-1 as unsigned keys — a stable
    least-significant-first radix pass per key.  Returns ``(perm, sorted
    rows, keep)``: ``keep`` marks each valid row that differs from its
    predecessor, or starts its block."""
    perm = torch.arange(seeds.shape[0], device=seeds.device)
    for w in reversed(range(seeds.shape[1])):
        perm = perm[_stable_order(unsigned_key(seeds[perm, w]))]
    perm = perm[_stable_order((~valid[perm]).to(torch.uint8))]
    if block is not None:
        perm = perm[_stable_order(block[perm])]
    seeds = seeds[perm]
    valid = valid[perm]
    same_prev = (seeds == seeds.roll(1, 0)).all(-1)
    same_prev[:1] = False
    if block is not None:
        b = block[perm]
        same_prev &= b == b.roll(1)
    return perm, seeds, valid & ~(same_prev & valid.roll(1))


def _sort_unique(seeds: torch.Tensor, valid: torch.Tensor, *arrays) -> tuple:
    """Lexsort packed rows, mark adjacent duplicates, compact survivors.
    Returns ``(count, seeds, *arrays)`` with the unique valid rows, in
    unsigned row order, moved to the front."""
    perm, seeds, keep = _unique_rows(seeds, valid)
    return _compact(keep, seeds, *(a[perm] for a in arrays))


def _take_blocks(a: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``a[i, perm[i]]`` for every block ``i`` of a ``[nb, Bc, ...]`` stack."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], perm]


def _compact_blocks(valid: torch.Tensor, *arrays) -> tuple:
    """:func:`_compact` in every block of ``[nb, Bc, ...]`` stacks at once:
    returns ``([nb] counts, *reordered stacks)``, each block exactly what
    ``_compact`` gives it alone."""
    perm = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    return (valid.sum(-1, dtype=torch.int32), *(_take_blocks(a, perm) for a in arrays))


def _sort_unique_blocks(seeds: torch.Tensor, valid: torch.Tensor, *arrays) -> tuple:
    """:func:`_sort_unique` in every block of ``[nb, Bc, W]`` stacks at once:
    one lexsort with the block index as the most significant key keeps each
    block's rows in its own ``Bc`` slots, and duplicates are marked within
    a block only.  Returns ``([nb] counts, seeds, *arrays)`` as stacks."""
    nb, Bc, W = seeds.shape
    block = torch.arange(nb, device=seeds.device)[:, None].expand(nb, Bc).reshape(-1)
    perm, flat, keep = _unique_rows(seeds.reshape(nb * Bc, W), valid.reshape(-1), block)
    rest = (a.reshape(nb * Bc, *a.shape[2:])[perm].reshape(a.shape) for a in arrays)
    return _compact_blocks(keep.reshape(nb, Bc), flat.reshape(nb, Bc, W), *rest)


def slice_pad(arr: torch.Tensor, lo: int, cap: int, fill=0) -> torch.Tensor:
    """Static-shape window ``arr[lo:lo+cap]``, padded with ``fill`` past the
    end — keeps chunk shapes bucketed without a host round-trip.  Rows past
    ``lo + cap`` are not in this window; the caller covers them with
    further windows (the drivers' chunk loops)."""
    chunk = arr[lo : lo + cap]
    short = cap - chunk.shape[0]
    if short > 0:
        pad = torch.full((short, *arr.shape[1:]), fill, dtype=arr.dtype, device=arr.device)
        chunk = torch.cat([chunk, pad])
    return chunk


# ---------------------------------------------------------------------------
# expansion and filter stages
# ---------------------------------------------------------------------------


def expand_oplus(frontier, n_valid, LOW, BIT, *, n_attrs: int, dedupe: bool):
    """⊕-expansion of a frontier [F, W] → compacted seeds [F·m, W] + count.

    ``n_valid`` is the frontier's row count, an int or a 0-dim device
    tensor (an async round's chained count).  ``dedupe=True`` is
    MRGanter+'s local pruning: duplicate seeds die here, before any round
    is sized (``dedupe_candidates``).
    """
    F, W = frontier.shape
    row_ok = torch.arange(F, device=frontier.device) < n_valid
    seeds, valid = lectic.oplus_seeds_torch(frontier, LOW, BIT, n_attrs)
    valid = valid & row_ok[:, None]
    seeds = seeds.reshape(F * n_attrs, W)
    valid = valid.reshape(F * n_attrs)
    if dedupe:
        n, seeds = _sort_unique(seeds, valid)
    else:
        n, seeds = _compact(valid, seeds)
    return seeds, n


def expand_cbo(frontier, gens, n_valid, BIT, *, n_attrs: int):
    """CbO expansion: seeds ``Y ∪ {a}`` for ``a > gen(Y), a ∉ Y``.

    Returns compacted ``(seeds [F·m, W], parent_rows, gen_attr, count)`` —
    parent/generator lineage rides along for the canonicity filter.
    """
    F, W = frontier.shape
    dev = frontier.device
    row_ok = torch.arange(F, device=dev) < n_valid
    seeds, valid = lectic.cbo_seeds_torch(frontier, gens, BIT, n_attrs)
    valid = valid & row_ok[:, None]
    seeds = seeds.reshape(F * n_attrs, W)
    valid = valid.reshape(F * n_attrs)
    parent = torch.arange(F, dtype=torch.int32, device=dev)[:, None].expand(F, n_attrs)
    parent = parent.reshape(-1)
    gen = torch.arange(n_attrs, dtype=torch.int32, device=dev).repeat(F)
    n, seeds, parent, gen = _compact(valid, seeds, parent, gen)
    return seeds, frontier[parent.long()], gen, n


def unique_closures(closures, n_valid):
    """Intra-batch dedupe of closure outputs: sorted-unique + compaction.

    The cross-iteration novelty check stays with the host registry; this
    stage collapses the (heavily duplicated) round output so only distinct
    intents cross the device→host boundary.
    """
    valid = torch.arange(closures.shape[0], device=closures.device) < n_valid
    n, closures = _sort_unique(closures, valid)
    return closures, n


# -- candidate-axis (2-D) block merges ---------------------------------------
# The block-local filters of a 2-D round leave [cand_parts, Bc, ...] stacks
# with their survivors front-packed per block, and per-block counts; these
# merges consume the gathered stacks and produce the chunk's survivors.


def _block_valid(counts, Bc):
    """Flattened validity mask for gathered [cand, Bc, ...] block stacks."""
    return (torch.arange(Bc, device=counts.device)[None, :] < counts[:, None]).reshape(-1)


def merge_blocks_plain(gc_blocks):
    """No filter ran: concatenating blocks restores the chunk's row order
    (block i held rows [i·Bc, (i+1)·Bc) of the chunk)."""
    return gc_blocks.reshape(-1, gc_blocks.shape[-1])


def merge_blocks_compact(gc_blocks, counts):
    """Compact each block's survivors (already front-packed) into one run."""
    valid = _block_valid(counts, gc_blocks.shape[1])
    n, gc = _compact(valid, gc_blocks.reshape(-1, gc_blocks.shape[-1]))
    return gc, n


def merge_blocks_unique(gc_blocks, counts):
    """Block-local dedupe removed intra-block duplicates; this pass removes
    the cross-block ones (sorted-unique over the concatenated survivors)."""
    valid = _block_valid(counts, gc_blocks.shape[1])
    n, gc = _sort_unique(gc_blocks.reshape(-1, gc_blocks.shape[-1]), valid)
    return gc, n


def merge_blocks_cbo(gc_blocks, gen_blocks, counts):
    """CbO survivors with their generator lineage (canonicity already ran
    block-locally; canonical survivors are globally unique, so compaction
    is the whole merge)."""
    valid = _block_valid(counts, gc_blocks.shape[1])
    n, gc, gens = _compact(
        valid, gc_blocks.reshape(-1, gc_blocks.shape[-1]), gen_blocks.reshape(-1)
    )
    return gc, gens, n


def filter_canonical(closures, parents, gens, n_valid, LOW):
    """CbO canonicity ``(Z ^ Y) & LOW[a] == 0`` + survivor compaction.

    Survivors are *exactly* the new concepts (CbO generates each concept
    once under this test), so they double as the next device frontier.
    """
    ok = lectic.feasible_torch(closures, parents, gens, LOW)
    ok = ok & (torch.arange(closures.shape[0], device=closures.device) < n_valid)
    n, closures, gens = _compact(ok, closures, gens)
    return closures, gens, n


def ganter_select(closures, Y, valid, LOW, mask, *, n_attrs: int):
    """NextClosure's Alg.-5 scan as one device step: feasibility for every
    generator attribute, then the *largest* feasible one wins."""
    gens = torch.arange(n_attrs, dtype=torch.int32, device=closures.device)
    ok = lectic.feasible_torch(closures[:n_attrs], Y[None, :], gens, LOW)
    ok = ok & valid
    Y_next, _ = lectic.select_lectic(closures[:n_attrs], ok)
    return Y_next, (Y_next == mask).all()


# ---------------------------------------------------------------------------
# speculative round state (async rounds)
# ---------------------------------------------------------------------------


def _pack_round(a, b, payload) -> torch.Tensor:
    """A round's two counts and its payload rows as ONE int32 device buffer
    ``[a, b, payload.ravel()]``: the round's whole readback in one copy."""
    head = torch.stack([a.to(torch.int32).reshape(()), b.to(torch.int32).reshape(())])
    return torch.cat([head, payload.reshape(-1).to(torch.int32)])


def _start_d2h(packed: torch.Tensor):
    """Start the copy of a packed round buffer to the host without waiting.

    On a CUDA device: a pinned host tensor of the same shape, filled by a
    ``non_blocking`` copy on the current (compute) stream — so it is
    ordered after the round's kernels with no ``wait_stream`` — and an
    event recorded behind it.  Returns ``(host, event)``.  On the CPU the
    buffer is already on the host: ``(packed, None)``."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(torch.cuda.current_stream(packed.device))
    return host, copied


@dataclasses.dataclass
class SpecRound:
    """One in-flight speculative round: the second frontier slot.

    Holds the expansion buffers round r was dispatched from (so that an
    under-covered speculation can re-chunk them synchronously), the
    survivor buffers the *next* round was chained on, and the packed
    readback: the device buffer, its host copy (pinned, on a CUDA device)
    and the event that marks the copy done.  ``cap`` is the speculative
    chunk's padded coverage — reconciliation compares it with the true
    seed count; ``slot`` is how many survivor rows the adopted slot kept (a
    true survivor count past it means the round in flight chained on a
    truncated frontier and must be discarded).
    """

    kind: str  # "oplus" | "cbo" | "ganter"
    packed: torch.Tensor
    host: torch.Tensor
    copied: object  # torch.cuda.Event, or None on the CPU
    cap: int
    blk: int
    two_d: bool
    seeds: torch.Tensor | None = None
    parents: torch.Tensor | None = None
    gen: torch.Tensor | None = None
    surv_z: torch.Tensor | None = None
    surv_g: torch.Tensor | None = None
    slot: int = 0
    # the round's sequence number (its async track id) and dispatch time
    # (the round latency is reconcile − dispatch)
    seq: int = 0
    t_dispatch: float = 0.0


@dataclasses.dataclass
class OplusRound:
    """Reconciled MRGanter+ round: true seed count + the round's closures."""

    n_seeds: int
    closures: np.ndarray
    under_covered: bool


@dataclasses.dataclass
class CboRound:
    """Reconciled MRCbo round: true seed count + canonical survivors."""

    n_seeds: int
    new_intents: np.ndarray
    n_new: int
    under_covered: bool


# ---------------------------------------------------------------------------
# driver-facing pipeline
# ---------------------------------------------------------------------------


class DeviceFrontier:
    """Holds the frontier state for one mining run and exposes the
    per-iteration steps the MR* drivers are written in.

    The engine provides the rows and the round builders; this class owns
    expansion/pruning orchestration, the post-round filters, and the
    bucket/chunk bookkeeping.
    """

    def __init__(self, engine, *, dedupe_closures: bool = False):
        self.engine = engine
        self.n_attrs = engine.ctx.n_attrs
        self.W = engine.ctx.W
        # Collapse duplicate *closure outputs* on device before download.
        self.dedupe_closures = dedupe_closures
        self._frontier = None  # [Fb, W]
        self._gens = None  # [Fb] (CbO lineage)
        self._n = 0
        # Async rounds: while an adopted speculative round is unreconciled,
        # ``_n`` is None and the frontier's count lives on the device in
        # ``_n_dev``, the next round chaining on it with no host read.
        self._n_dev = None
        # The last reconciled true seed / survivor counts: they size the
        # next speculative chunk and its adopted slot (_spec_caps,
        # _slot_rows).  Hints only: one too small triggers the
        # under-coverage fallback, never a wrong result.
        self._seed_hint = None
        self._k_hint = None
        # round sequence number and plan-geometry tags of the round spans
        self._seq = 0
        self._tags = engine.plan.trace_tags()
        # Tables and built steps are memoized on the ENGINE: a driver builds
        # a fresh DeviceFrontier per run, and every frontier of an engine
        # shares them.  Steps are built lazily (``_step_fn``).
        cache = getattr(engine, "_frontier_cache", None)
        if cache is None:
            cache = engine._frontier_cache = self._build_cache(engine)
        self._cache = cache
        self.LOW = cache["LOW"]
        self.BIT = cache["BIT"]

    @staticmethod
    def _build_cache(engine) -> dict:
        t = lectic.LecticTables(engine.ctx.n_attrs)
        n_attrs = engine.ctx.n_attrs
        LOW = engine.plan.replicate(t.LOW, engine.device)
        BIT = engine.plan.replicate(t.BIT, engine.device)
        mask = engine.mask

        def post_cbo(gc, parents, gens, n_valid):
            return filter_canonical(gc, parents, gens, n_valid, LOW)

        def post_ganter(gc, Y, valid):
            return ganter_select(gc, Y, valid, LOW, mask, n_attrs=n_attrs)

        # Iceberg posts: min_support is a plain operand, so one step serves
        # every threshold.  Infrequent candidates are compacted away right
        # after the support sum — never downloaded or re-expanded.
        def post_iceberg(gc, gs, n_valid, min_sup):
            rows_ok = torch.arange(gc.shape[0], device=gc.device) < n_valid
            n, gc = _compact(rows_ok & (gs >= min_sup), gc)
            return gc, n

        def post_iceberg_unique(gc, gs, n_valid, min_sup):
            rows_ok = torch.arange(gc.shape[0], device=gc.device) < n_valid
            n, gc = _sort_unique(gc, rows_ok & (gs >= min_sup))
            return gc, n

        def post_cbo_iceberg(gc, gs, parents, gens, n_valid, min_sup):
            ok = lectic.feasible_torch(gc, parents, gens, LOW)
            ok = ok & (torch.arange(gc.shape[0], device=gc.device) < n_valid)
            ok = ok & (gs >= min_sup)
            n, gc, gens = _compact(ok, gc, gens)
            return gc, gens, n

        def post_ganter_iceberg(gc, gs, Y, valid, min_sup):
            # Alg.-5 scan restricted to *frequent* successors: the next
            # frequent closure in lectic order is Y ⊕ a for the largest
            # feasible a with support ≥ min_sup.
            gens = torch.arange(n_attrs, dtype=torch.int32, device=gc.device)
            ok = lectic.feasible_torch(gc[:n_attrs], Y[None, :], gens, LOW)
            ok = ok & valid & (gs[:n_attrs] >= min_sup)
            Y_next, found = lectic.select_lectic(gc[:n_attrs], ok)
            return Y_next, ~found

        # Candidate-axis (2-D) posts: the same filters made block-local,
        # batched over the [nb, Bc] blocks a process holds; ``idx`` gives
        # each block's position, from which row validity is rebuilt out of
        # the replicated valid count.  Survivors are gathered along the
        # candidate axis only after these run (the merge_blocks_* stages).
        def _bvalid(idx, Bc, n_valid):
            return (torch.arange(Bc, device=idx.device)[None, :] + idx[:, None] * Bc) < n_valid

        def post2d_unique(idx, gc, n_valid):
            n, gc = _sort_unique_blocks(gc, _bvalid(idx, gc.shape[1], n_valid))
            return gc, n

        def post2d_iceberg(idx, gc, gs, n_valid, min_sup):
            keep = _bvalid(idx, gc.shape[1], n_valid) & (gs >= min_sup)
            n, gc = _compact_blocks(keep, gc)
            return gc, n

        def post2d_iceberg_unique(idx, gc, gs, n_valid, min_sup):
            keep = _bvalid(idx, gc.shape[1], n_valid) & (gs >= min_sup)
            n, gc = _sort_unique_blocks(gc, keep)
            return gc, n

        def post2d_cbo(idx, gc, parents, gens, n_valid):
            ok = lectic.feasible_torch(gc, parents, gens, LOW)
            ok = ok & _bvalid(idx, gc.shape[1], n_valid)
            n, gc, gens = _compact_blocks(ok, gc, gens)
            return gc, gens, n

        def post2d_cbo_iceberg(idx, gc, gs, parents, gens, n_valid, min_sup):
            ok = lectic.feasible_torch(gc, parents, gens, LOW)
            ok = ok & _bvalid(idx, gc.shape[1], n_valid) & (gs >= min_sup)
            n, gc, gens = _compact_blocks(ok, gc, gens)
            return gc, gens, n

        builders = {
            "plain": lambda: engine.spmd_step(),
            "unique": lambda: engine.spmd_step(unique_closures, n_extra=1),
            "cbo": lambda: engine.spmd_step(post_cbo, n_extra=3),
            "ganter": lambda: engine.spmd_step(post_ganter, n_extra=2),
            "iceberg": lambda: engine.spmd_step(
                post_iceberg, with_supports=True, n_extra=2
            ),
            "iceberg_unique": lambda: engine.spmd_step(
                post_iceberg_unique, with_supports=True, n_extra=2
            ),
            "cbo_iceberg": lambda: engine.spmd_step(
                post_cbo_iceberg, with_supports=True, n_extra=4
            ),
            "ganter_iceberg": lambda: engine.spmd_step(
                post_ganter_iceberg, with_supports=True, n_extra=3
            ),
            # 2-D (candidate × object) variants: one round per chunk of
            # cand_parts blocks — map + object reduce per block, block-local
            # filter, candidate-axis survivor gather, merge.  Built only when
            # a driver runs on a 2-D plan.
            "plain2d": lambda: engine.spmd_step_cand(None, merge_blocks_plain),
            "unique2d": lambda: engine.spmd_step_cand(
                post2d_unique, merge_blocks_unique, n_post_rep=1
            ),
            "iceberg2d": lambda: engine.spmd_step_cand(
                post2d_iceberg, merge_blocks_compact, with_supports=True, n_post_rep=2
            ),
            "iceberg_unique2d": lambda: engine.spmd_step_cand(
                post2d_iceberg_unique, merge_blocks_unique, with_supports=True, n_post_rep=2
            ),
            "cbo2d": lambda: engine.spmd_step_cand(
                post2d_cbo, merge_blocks_cbo, n_cand=3, n_post_rep=1
            ),
            "cbo_iceberg2d": lambda: engine.spmd_step_cand(
                post2d_cbo_iceberg, merge_blocks_cbo, with_supports=True, n_cand=3,
                n_post_rep=2,
            ),
        }
        # backend="kernel": every batched step variant runs the fused
        # kernels (K2 on one shard, K3 → reduce → K4 on k > 1), 1-D and
        # 2-D.  The single-intent ganter walks keep the spmd_step builders —
        # their map runs K1, and their argmax-select has no batch filter to
        # fuse.
        if engine.backend == "kernel":
            merges = {
                "plain": merge_blocks_plain,
                "unique": merge_blocks_unique,
                "iceberg": merge_blocks_compact,
                "iceberg_unique": merge_blocks_unique,
                "cbo": merge_blocks_cbo,
                "cbo_iceberg": merge_blocks_cbo,
            }
            for v in fkern.VARIANTS:
                builders[v] = lambda v=v: engine.spmd_step_fused(v, LOW)
                builders[v + "2d"] = lambda v=v: engine.spmd_step_cand_fused(v, LOW, merges[v])
        return {"LOW": LOW, "BIT": BIT, "steps": {}, "builders": builders}

    def _step_fn(self, name: str):
        """Step ``name``, built on first use and memoized on the engine."""
        steps = self._cache["steps"]
        fn = steps.get(name)
        if fn is None:
            fn = steps[name] = self._cache["builders"][name]()
        return fn

    # -- frontier state ----------------------------------------------------

    def __len__(self) -> int:
        if self._n is None:
            raise RuntimeError(
                "frontier count is speculative — reconcile the in-flight "
                "round before asking for len()"
            )
        return self._n

    def set_frontier(self, intents: np.ndarray, gens: np.ndarray | None = None):
        """Upload a new frontier (one bulk H2D — the Twister dynamic delta)."""
        n = intents.shape[0]
        cap = ops.bucket_size(max(1, n))
        buf = np.zeros((cap, self.W), np.uint32)
        buf[:n] = intents
        plan, dev = self.engine.plan, self.engine.device
        self._frontier = plan.replicate(buf, dev)
        st = self.engine.stats
        st.h2d_transfers += 1
        st.h2d_bytes += buf.nbytes
        if gens is not None:
            gbuf = np.zeros((cap,), np.int32)
            gbuf[:n] = gens
            self._gens = plan.replicate(gbuf, dev)
            st.h2d_transfers += 1
            st.h2d_bytes += gbuf.nbytes
        self._n = n
        # not a _k_hint: an uploaded frontier's row count says little of
        # the next round's survivors, and with _n known the next
        # speculative chunk is sized exactly anyway
        self._n_dev = None

    def _adopt(self, frontier_dev, gens_dev, n: int):
        """Keep device survivors as the next frontier (no host round-trip).

        ``slice_pad`` here only ever *grows* the buffer to the next bucket:
        the guard makes dropping live rows a loud error instead of a
        silent truncation.
        """
        if n > frontier_dev.shape[0]:
            raise RuntimeError(
                f"_adopt: {n} surviving frontier rows but only "
                f"{frontier_dev.shape[0]} device rows were materialized — "
                "adopting would silently drop concepts.  Raise max_batch or "
                "shard the frontier axis (ShardPlan cand_parts / "
                "--cand-shards)."
            )
        cap = ops.bucket_size(max(1, n))
        self._frontier = slice_pad(frontier_dev, 0, cap)
        self._gens = None if gens_dev is None else slice_pad(gens_dev, 0, cap)
        self._n = n
        self._n_dev = None
        self._k_hint = max(1, n)

    def _download(self, arr_dev, n: int) -> np.ndarray:
        st = self.engine.stats
        t0 = time.perf_counter()
        out = host_bits(arr_dev[:n])
        st.host_blocked_s += time.perf_counter() - t0
        st.d2h_transfers += 1
        st.d2h_bytes += out.nbytes
        return out

    def _block_scalar(self, x_dev) -> int:
        """Host-blocking scalar readback, ledgered as a 4-byte D2H transfer
        plus the wall time the host spent waiting on it."""
        st = self.engine.stats
        t0 = time.perf_counter()
        v = int(x_dev)
        st.host_blocked_s += time.perf_counter() - t0
        st.d2h_transfers += 1
        st.d2h_bytes += 4
        return v

    # -- chunk geometry ----------------------------------------------------

    @property
    def cand_parts(self) -> int:
        return self.engine.plan.cand_parts

    @property
    def round_budget(self) -> int:
        """Candidates one closure round absorbs: ``max_batch`` on a 1-D
        plan; ``cand_parts`` blocks of up to ``max_batch`` each on a 2-D
        plan, so the per-round budget multiplies while each block stays
        bounded."""
        return self.engine.max_batch * self.cand_parts

    def _block_cap(self, b: int) -> int:
        """Bucketed per-block capacity for a chunk of ``b`` candidates
        spread over the plan's candidate blocks."""
        return ops.bucket_size(-(-b // self.cand_parts), minimum=self.engine.min_bucket)

    def _chunk_caps(self, b: int) -> tuple[int, int]:
        """(padded chunk capacity, per-block capacity) for ``b`` seeds."""
        if self.cand_parts > 1:
            blk = self._block_cap(b)
            return blk * self.cand_parts, blk
        cap = ops.bucket_size(b, minimum=self.engine.min_bucket)
        return cap, cap

    def _charge(self, two_d: bool, blk: int, cap: int, b: int, count: bool):
        if two_d:
            self.engine.charge_round_cand(blk, b, count_round=count)
        else:
            self.engine.charge_round(cap, b, count_round=count)

    def _next_seq(self) -> int:
        """Monotone round sequence number — the round span's index."""
        s = self._seq
        self._seq = s + 1
        return s

    # -- fused per-iteration steps ----------------------------------------

    def step_oplus(
        self, *, dedupe: bool, min_support: int | None = None
    ) -> np.ndarray:
        """One MRGanter+ iteration: expand → local prune → close → collect.

        Returns the round's closure intents (host array; de-duplicated on
        device when ``dedupe_closures``); the caller runs the global-
        registry novelty check and hands the novel rows back via
        :meth:`set_frontier`.  With ``min_support``, infrequent closures
        are compacted away on the device and never cross to the host.
        """
        tr = obs.current()
        seq = self._next_seq()
        t_round = time.perf_counter()
        with tr.span(f"mine/round[{seq}]", algo="oplus", mode="sync", **self._tags) as sp:
            with tr.span(f"mine/round[{seq}]/expand"):
                t0 = time.perf_counter()
                seeds, n_dev = expand_oplus(
                    self._frontier, self._n, self.LOW, self.BIT,
                    n_attrs=self.n_attrs, dedupe=dedupe,
                )
                self.engine.stats.dispatch_s += time.perf_counter() - t0
                n_seeds = self._block_scalar(n_dev)  # sizes the rounds to the prune
            if n_seeds == 0:
                return np.zeros((0, self.W), np.uint32)
            self._seed_hint = n_seeds
            out = np.concatenate(
                self._oplus_chunks(seeds, n_seeds, 0, min_support=min_support, first=True,
                                   seq=seq),
                axis=0,
            )
            sp.set(n_seeds=n_seeds, survivors=int(out.shape[0]))
        self.engine.stats.observe_latency("round", time.perf_counter() - t_round)
        return out

    def _oplus_chunks(self, seeds, n_seeds: int, lo0: int, *, min_support: int | None,
                      first: bool, seq: int, force_unique: bool = False):
        """Close seeds ``[lo0, n_seeds)`` in ``round_budget`` chunks, one
        round each, downloading every chunk's survivors.  Shared by the sync
        step and the async under-coverage fallback (``force_unique``: the
        closure-dedupe steps an async round runs).  Every filter is
        row-wise, so chunk and block boundaries never change the surviving
        rows — only how many rounds produce them."""
        eng = self.engine
        tr = obs.current()
        pfx = f"mine/round[{seq}]"
        two_d = self.cand_parts > 1
        sfx = "2d" if two_d else ""
        unique = self.dedupe_closures or force_unique
        parts = []
        for lo in range(lo0, n_seeds, self.round_budget):
            b = min(self.round_budget, n_seeds - lo)
            cap, blk = self._chunk_caps(b)
            chunk = slice_pad(seeds, lo, cap)
            t0 = time.perf_counter()
            if min_support is not None or unique:
                if min_support is None:
                    name, extra = "unique", ()
                else:
                    name = "iceberg_unique" if unique else "iceberg"
                    extra = (min_support,)
                with tr.span(pfx + "/dispatch", chunk=b, cap=cap):
                    cl, k_dev = self._step_fn(name + sfx)(eng.rows, chunk, b, *extra)
                    eng.stats.dispatch_s += time.perf_counter() - t0
                self._charge(two_d, blk, cap, b, first)
                with tr.span(pfx + "/allreduce"):
                    k = self._block_scalar(k_dev)
                with tr.span(pfx + "/filter", survivors=k):
                    parts.append(self._download(cl, k))
            else:
                with tr.span(pfx + "/dispatch", chunk=b, cap=cap):
                    closures = self._step_fn("plain" + sfx)(eng.rows, chunk)
                    eng.stats.dispatch_s += time.perf_counter() - t0
                self._charge(two_d, blk, cap, b, first)
                with tr.span(pfx + "/filter", survivors=b):
                    parts.append(self._download(closures, b))
            first = False
        return parts

    def step_cbo(
        self, *, min_support: int | None = None
    ) -> tuple[np.ndarray, int, int]:
        """One MRCbo iteration: expand → close+canonicity → adopt.

        Canonical survivors stay on device as the next frontier and the
        same rows are downloaded once for the result set.  With
        ``min_support`` the support filter runs in the same step (CbO
        intents only grow along the tree, so pruning is lossless).
        Returns ``(new_intents, n_seeds, n_new)`` — ``n_seeds`` is 0 when
        the frontier was already exhausted (no closure round ran).
        """
        tr = obs.current()
        seq = self._next_seq()
        t_round = time.perf_counter()
        with tr.span(f"mine/round[{seq}]", algo="cbo", mode="sync", **self._tags) as sp:
            with tr.span(f"mine/round[{seq}]/expand"):
                t0 = time.perf_counter()
                seeds, parents, gen, n_dev = expand_cbo(
                    self._frontier, self._gens, self._n, self.BIT, n_attrs=self.n_attrs
                )
                self.engine.stats.dispatch_s += time.perf_counter() - t0
                n_seeds = self._block_scalar(n_dev)
            if n_seeds == 0:
                self._n = 0
                return np.zeros((0, self.W), np.uint32), 0, 0
            self._seed_hint = n_seeds
            surv_z, surv_g, counts = self._cbo_chunks(
                seeds, parents, gen, n_seeds, 0, min_support=min_support, first=True, seq=seq
            )
            n_new = sum(counts)
            sp.set(n_seeds=n_seeds, survivors=n_new)
            if n_new == 0:
                self._n = 0
                self.engine.stats.observe_latency("round", time.perf_counter() - t_round)
                return np.zeros((0, self.W), np.uint32), n_seeds, 0
            z_all = surv_z[0] if len(surv_z) == 1 else torch.cat(surv_z)
            g_all = surv_g[0] if len(surv_g) == 1 else torch.cat(surv_g)
            self._adopt(z_all, g_all, n_new)
            with tr.span(f"mine/round[{seq}]/filter", survivors=n_new):
                out = self._download(self._frontier, n_new)
        self.engine.stats.observe_latency("round", time.perf_counter() - t_round)
        return out, n_seeds, n_new

    def _cbo_chunks(self, seeds, parents, gen, n_seeds: int, lo0: int, *, min_support,
                    first: bool, seq: int):
        """Close+canonicity for CbO seeds ``[lo0, n_seeds)`` in
        ``round_budget`` chunks.  Returns device survivor buffers ``(z_list,
        g_list, k_list)``.  Shared by the sync step and the async
        under-coverage fallback."""
        eng = self.engine
        tr = obs.current()
        pfx = f"mine/round[{seq}]"
        two_d = self.cand_parts > 1
        name = ("cbo" if min_support is None else "cbo_iceberg") + ("2d" if two_d else "")
        extra = () if min_support is None else (min_support,)
        surv_z, surv_g, counts = [], [], []
        for lo in range(lo0, n_seeds, self.round_budget):
            b = min(self.round_budget, n_seeds - lo)
            cap, blk = self._chunk_caps(b)
            args = (
                eng.rows,
                slice_pad(seeds, lo, cap),
                slice_pad(parents, lo, cap),
                slice_pad(gen, lo, cap),
                b,
            )
            t0 = time.perf_counter()
            with tr.span(pfx + "/dispatch", chunk=b, cap=cap):
                z, g, k_dev = self._step_fn(name)(*args, *extra)
                eng.stats.dispatch_s += time.perf_counter() - t0
            self._charge(two_d, blk, cap, b, first)
            first = False
            with tr.span(pfx + "/allreduce"):
                k = self._block_scalar(k_dev)
            if k:
                surv_z.append(z[:k])
                surv_g.append(g[:k])
                counts.append(k)
        return surv_z, surv_g, counts

    def step_ganter(
        self, *, min_support: int | None = None
    ) -> tuple[np.ndarray, bool]:
        """One MRGanter iteration: ⊕-seeds for the single current intent,
        then one round: closure map → Alg.-5 feasibility scan →
        argmax-select.  Returns ``(next intent (host), reached ⊤)``.

        With ``min_support`` the scan restricts to frequent successors and
        the flag flips to "no frequent successor exists" — when True, the
        returned intent is garbage the caller must NOT emit.

        Always runs the 1-D step, even on a 2-D plan: the frontier is a
        single intent whose ≤ n_attrs seeds fit any block, and the Alg.-5
        argmax-select needs every seed's closure in one place anyway.
        """
        eng = self.engine
        tr = obs.current()
        seq = self._next_seq()
        t_round = time.perf_counter()
        with tr.span(f"mine/round[{seq}]", algo="ganter", mode="sync", **self._tags):
            with tr.span(f"mine/round[{seq}]/dispatch"):
                Y_next, done, nv_dev, cap = self._dispatch_ganter(min_support)
            with tr.span(f"mine/round[{seq}]/allreduce"):
                eng.charge_round(cap, self._block_scalar(nv_dev))
            with tr.span(f"mine/round[{seq}]/filter"):
                Y_host = self._download(Y_next[None, :], 1)[0]
                flag = bool(self._block_scalar(done))
        eng.stats.observe_latency("round", time.perf_counter() - t_round)
        return Y_host, flag

    def _dispatch_ganter(self, min_support):
        """Enqueue one Alg.-5 step (no host read): seed expansion, the
        closure → select round and the on-device frontier swap.  Returns
        ``(Y_next, done, n_valid_seeds, cap)``, all but ``cap`` on the
        device."""
        eng = self.engine
        t0 = time.perf_counter()
        Y = self._frontier[0]
        seeds, valid = lectic.oplus_seeds_torch(Y[None, :], self.LOW, self.BIT, self.n_attrs)
        seeds = seeds.reshape(self.n_attrs, self.W)
        cap = ops.bucket_size(self.n_attrs, minimum=eng.min_bucket)
        chunk = slice_pad(seeds, 0, cap)
        if min_support is not None:
            Y_next, done = self._step_fn("ganter_iceberg")(
                eng.rows, chunk, Y, valid[0], min_support
            )
        else:
            Y_next, done = self._step_fn("ganter")(eng.rows, chunk, Y, valid[0])
        self._frontier = Y_next[None, :].expand(self._frontier.shape[0], self.W)
        self._n = 1
        eng.stats.dispatch_s += time.perf_counter() - t0
        return Y_next, done, valid[0].sum(dtype=torch.int32), cap

    # -- speculative rounds (async rounds) ---------------------------------
    #
    # The async drivers dispatch round r+1's expansion against round r's
    # *unreconciled* survivor buffer: every step takes the valid count as
    # an int or a 0-dim device tensor, so the whole chain — expand → close
    # → filter → adopt — runs on device counts and the host never blocks
    # between rounds.  Each round's one readback is a packed buffer (counts
    # and survivors, ``_pack_round``) whose copy to pinned host memory is
    # enqueued at dispatch; ``reconcile_*`` waits on it only when the
    # driver needs round r's result, by which time round r+1 is in flight.
    #
    # Speculation is capped at ``round_budget``: the chunk covers
    # min(expansion bound, round_budget) seeds, bucket-padded.
    # Reconciliation compares the true seed count with that coverage: rows
    # past the true count were masked by the device count (nothing
    # re-runs), and only under-coverage falls back to a synchronous
    # re-dispatch of the uncovered tail through the shared chunk runners.
    # Stats are charged at reconcile time, when the true counts are known,
    # so a discarded round's modeled cost is never charged.

    def _n_arg(self):
        """The frontier's valid count as a step operand — the host int when
        reconciled, the device count when speculative (never a readback)."""
        return self._n_dev if self._n is None else self._n

    def _adopt_spec(self, frontier_dev, gens_dev, k_dev):
        """Adopt a speculative survivor buffer whose count is still on the
        device.  The buffer is pre-sliced to ``_slot_rows``, smaller than
        the chunk cap, so ``_adopt``'s refuse-to-drop guard cannot run
        here; reconciliation makes the same check against the true count
        (``k > spec.slot``) once the packed buffer lands."""
        self._frontier = frontier_dev
        self._gens = gens_dev
        self._n = None
        self._n_dev = k_dev

    def _spec_caps(self, bound: int) -> tuple[int, int]:
        """Speculative chunk coverage: min(expansion bound, round_budget),
        bucket-padded; ``(cap, blk)`` as :meth:`_chunk_caps` gives them.

        The structural bound (slot rows × n_attrs) overstates the deduped
        seed count by far, and a speculative round pays for its whole
        padded cap, while an under-covered one re-runs only the uncovered
        tail.  So once a reconciled round has told the true count, the
        chunk is sized at twice that hint; a growth spurt past it falls
        back.  A latency heuristic, never a correctness input."""
        if self._seed_hint is not None:
            bound = min(bound, max(self.engine.min_bucket, 2 * self._seed_hint))
        return self._chunk_caps(max(1, min(bound, self.round_budget)))

    def _spec_bound(self) -> int:
        """Structural expansion bound for the next speculative chunk: the
        reconciled row count when the host knows it, the slot's padded
        capacity while the count is in flight."""
        rows = self._n if self._n is not None else self._frontier.shape[0]
        return max(1, rows) * self.n_attrs

    def _slot_rows(self, cap: int) -> int:
        """Rows the adopted speculative slot keeps: the next round's
        expansion input, whose cost scales with its rows.  Sized from the
        last reconciled survivor count with a 2× growth allowance; a growth
        spurt past the slot truncates live rows in flight, which the
        reconcile detects (``k > spec.slot``) from the full packed buffer
        and the mining loop recovers from by its under-coverage reset."""
        if self._k_hint is None:
            return cap
        rows = ops.bucket_size(max(self.engine.min_bucket, 2 * self._k_hint),
                               minimum=self.engine.min_bucket)
        return min(cap, rows)

    def _launch_readback(self, kind: str, a, b, payload, *, cap: int, blk: int, two_d: bool,
                         seq: int, t_dispatch: float, **bufs) -> SpecRound:
        """Pack the round's counts and payload, start their copy to the
        host, and keep every buffer alive in the round's record."""
        packed = _pack_round(a, b, payload)
        host, copied = _start_d2h(packed)
        return SpecRound(kind, packed, host, copied, cap, blk, two_d, seq=seq,
                         t_dispatch=t_dispatch, **bufs)

    def discard_spec(self, spec: SpecRound | None) -> None:
        """Drop a speculative round whose premise turned out wrong (the true
        frontier emptied, or under-coverage invalidated its input).  Its
        modeled cost is never charged, but its packed readback has been
        copying since dispatch, so the transfer census charges those
        bytes here."""
        if spec is not None:
            st = self.engine.stats
            st.spec_discarded += 1
            st.d2h_transfers += 1
            st.d2h_bytes += spec.packed.numel() * 4
            tr = obs.current()
            tr.instant(f"spec/discard[{spec.seq}]")
            tr.end_async(f"mine/round[{spec.seq}]", spec.seq, outcome="discard")

    def _download_packed(self, spec: SpecRound) -> np.ndarray:
        """The reconcile's ONE host-blocking wait: the packed round buffer,
        its copy in flight since dispatch.  Returns it as uint32 words."""
        st = self.engine.stats
        t0 = time.perf_counter()
        if spec.copied is not None:
            spec.copied.synchronize()
        out = host_bits(spec.host)
        st.host_blocked_s += time.perf_counter() - t0
        st.d2h_transfers += 1
        st.d2h_bytes += out.nbytes
        return out

    def _reconcile(self, spec: SpecRound, reconcile, min_support):
        """Run ``reconcile(spec, min_support=)`` inside the round's
        ``spec/reconcile`` span, then close its async track with the
        outcome and record the round's latency (dispatch to reconcile)."""
        tr = obs.current()
        with tr.span(f"spec/reconcile[{spec.seq}]") as sp:
            rec = reconcile(spec, min_support=min_support)
            outcome = "fallback" if rec.under_covered else "adopt"
            sp.set(outcome=outcome, n_seeds=rec.n_seeds)
        tr.end_async(f"mine/round[{spec.seq}]", spec.seq, outcome=outcome)
        self.engine.stats.observe_latency("round", time.perf_counter() - spec.t_dispatch)
        return rec

    def spec_oplus(self, *, dedupe: bool, min_support: int | None = None) -> SpecRound:
        """Dispatch one speculative MRGanter+ round (no host read).

        Always takes the *unique* step variants, whatever
        ``dedupe_closures`` says: the adopted slot is also the next round's
        expansion input, and deduping it on the device bounds the stale
        rows re-expanded (the host registry still owns novelty).
        """
        eng = self.engine
        tr = obs.current()
        seq = self._next_seq()
        t0 = time.perf_counter()
        tr.begin_async(f"mine/round[{seq}]", seq, algo="oplus", mode="async", **self._tags)
        with tr.span(f"spec/dispatch[{seq}]"):
            seeds, n_dev = expand_oplus(
                self._frontier, self._n_arg(), self.LOW, self.BIT,
                n_attrs=self.n_attrs, dedupe=dedupe,
            )
            cap, blk = self._spec_caps(self._spec_bound())
            chunk = slice_pad(seeds, 0, cap)
            nv = n_dev.clamp(max=cap)
            two_d = self.cand_parts > 1
            name = ("unique" if min_support is None else "iceberg_unique") + (
                "2d" if two_d else "")
            extra = () if min_support is None else (min_support,)
            cl, k_dev = self._step_fn(name)(eng.rows, chunk, nv, *extra)
            slot = self._slot_rows(cap)
            self._adopt_spec(cl if slot == cap else slice_pad(cl, 0, slot), None, k_dev)
            # the full survivor buffer crosses: recovery reads it
            spec = self._launch_readback("oplus", n_dev, k_dev, cl, cap=cap, blk=blk,
                                         two_d=two_d, seq=seq, t_dispatch=t0, seeds=seeds,
                                         slot=slot)
            eng.stats.dispatch_s += time.perf_counter() - t0
            eng.stats.spec_rounds += 1
        return spec

    def reconcile_oplus(self, spec: SpecRound, *, min_support: int | None = None) -> OplusRound:
        """Adopt round r's true counts: read the packed buffer, charge the
        round at its real size, and — only if the speculative chunk
        under-covered the true seed count — close the uncovered tail
        through the sync chunk runner."""
        return self._reconcile(spec, self._reconcile_oplus, min_support)

    def _reconcile_oplus(self, spec: SpecRound, *, min_support: int | None) -> OplusRound:
        eng = self.engine
        host = self._download_packed(spec)
        n_seeds, k = int(host[0]), int(host[1])
        if n_seeds == 0:
            # as in sync: no closure round ran, nothing is charged
            return OplusRound(0, np.zeros((0, self.W), np.uint32), False)
        self._seed_hint = n_seeds
        self._charge(spec.two_d, spec.blk, spec.cap, min(n_seeds, spec.cap), True)
        closures = host[2:].reshape(spec.cap, self.W)
        if n_seeds <= spec.cap:
            self._k_hint = max(1, k)
            new = np.ascontiguousarray(closures[:k])
            if k > spec.slot:
                # the adopted slot truncated the survivors in flight, so the
                # round speculating on it chained on a partial frontier; the
                # packed buffer holds them all, and the MR* loop's
                # under-coverage reset (discard, set_frontier, re-spec)
                # recovers with no recompute here
                eng.stats.spec_fallbacks += 1
                return OplusRound(n_seeds, new, True)
            return OplusRound(n_seeds, new, False)
        eng.stats.spec_fallbacks += 1
        parts = [np.ascontiguousarray(closures[:k])]
        parts += self._oplus_chunks(spec.seeds, n_seeds, spec.cap, min_support=min_support,
                                    first=False, force_unique=True, seq=spec.seq)
        out = np.concatenate(parts, axis=0)
        self._k_hint = max(1, out.shape[0])
        return OplusRound(n_seeds, out, True)

    def spec_cbo(self, *, min_support: int | None = None) -> SpecRound:
        """Dispatch one speculative MRCbo round (no host read).  Canonical
        survivors are adopted as the next frontier with their count still
        on the device — the sync contract minus the reads."""
        eng = self.engine
        tr = obs.current()
        seq = self._next_seq()
        t0 = time.perf_counter()
        tr.begin_async(f"mine/round[{seq}]", seq, algo="cbo", mode="async", **self._tags)
        with tr.span(f"spec/dispatch[{seq}]"):
            seeds, parents, gen, n_dev = expand_cbo(
                self._frontier, self._gens, self._n_arg(), self.BIT, n_attrs=self.n_attrs
            )
            cap, blk = self._spec_caps(self._spec_bound())
            two_d = self.cand_parts > 1
            name = ("cbo" if min_support is None else "cbo_iceberg") + ("2d" if two_d else "")
            extra = () if min_support is None else (min_support,)
            z, g, k_dev = self._step_fn(name)(
                eng.rows, slice_pad(seeds, 0, cap), slice_pad(parents, 0, cap),
                slice_pad(gen, 0, cap), n_dev.clamp(max=cap), *extra,
            )
            slot = self._slot_rows(cap)
            if slot == cap:
                self._adopt_spec(z, g, k_dev)
            else:
                self._adopt_spec(slice_pad(z, 0, slot), slice_pad(g, 0, slot), k_dev)
            spec = self._launch_readback("cbo", n_dev, k_dev, z, cap=cap, blk=blk, two_d=two_d,
                                         seq=seq, t_dispatch=t0, seeds=seeds, parents=parents,
                                         gen=gen, surv_z=z, surv_g=g, slot=slot)
            eng.stats.dispatch_s += time.perf_counter() - t0
            eng.stats.spec_rounds += 1
        return spec

    def reconcile_cbo(self, spec: SpecRound, *, min_support: int | None = None) -> CboRound:
        """Adopt round r's true counts.  When covered, the adopted slot
        already IS the true frontier (rows past the count were masked by
        the device count) and the survivors come straight from the packed
        buffer.  Under-coverage closes the uncovered tail synchronously and
        re-adopts the whole survivor set before the mining loop speculates again."""
        return self._reconcile(spec, self._reconcile_cbo, min_support)

    def _reconcile_cbo(self, spec: SpecRound, *, min_support: int | None) -> CboRound:
        eng = self.engine
        host = self._download_packed(spec)
        n_seeds, k = int(host[0]), int(host[1])
        if n_seeds == 0:
            # as in sync: the frontier was exhausted, no round ran or is charged
            self._n, self._n_dev = 0, None
            return CboRound(0, np.zeros((0, self.W), np.uint32), 0, False)
        self._seed_hint = n_seeds
        self._charge(spec.two_d, spec.blk, spec.cap, min(n_seeds, spec.cap), True)
        if n_seeds <= spec.cap:
            new = np.ascontiguousarray(host[2:].reshape(spec.cap, self.W)[:k])
            if k == 0:
                self._n, self._n_dev = 0, None
            elif k > spec.slot:
                # the slot truncated the survivors in flight: re-adopt the
                # whole survivor buffer (kept in the SpecRound for this), so
                # that the frontier is exact before the mining loop discards the
                # mispremised round and re-dispatches
                eng.stats.spec_fallbacks += 1
                self._adopt(spec.surv_z, spec.surv_g, k)
                return CboRound(n_seeds, new, k, True)
            else:
                self._k_hint = k
            return CboRound(n_seeds, new, k, False)
        eng.stats.spec_fallbacks += 1
        z_list, g_list, counts = self._cbo_chunks(
            spec.seeds, spec.parents, spec.gen, n_seeds, spec.cap,
            min_support=min_support, first=False, seq=spec.seq,
        )
        n_new = k + sum(counts)
        if n_new == 0:
            self._n, self._n_dev = 0, None
            return CboRound(n_seeds, np.zeros((0, self.W), np.uint32), 0, True)
        z_all = torch.cat([spec.surv_z[:k], *z_list])
        g_all = torch.cat([spec.surv_g[:k], *g_list])
        self._adopt(z_all, g_all, n_new)
        return CboRound(n_seeds, self._download(self._frontier, n_new), n_new, True)

    def spec_ganter(self, *, min_support: int | None = None) -> SpecRound:
        """Dispatch one speculative Alg.-5 step: the selected intent is
        broadcast into the frontier slot on the device, so the next step
        chains on it without the intent ever visiting the host."""
        eng = self.engine
        tr = obs.current()
        seq = self._next_seq()
        t_dispatch = time.perf_counter()
        tr.begin_async(f"mine/round[{seq}]", seq, algo="ganter", mode="async", **self._tags)
        with tr.span(f"spec/dispatch[{seq}]"):
            Y_next, done, nv_dev, cap = self._dispatch_ganter(min_support)
            t0 = time.perf_counter()
            spec = self._launch_readback("ganter", done, nv_dev, Y_next[None, :], cap=cap,
                                         blk=cap, two_d=False, seq=seq, t_dispatch=t_dispatch)
            eng.stats.dispatch_s += time.perf_counter() - t0
            eng.stats.spec_rounds += 1
        return spec

    def reconcile_ganter(self, spec: SpecRound) -> tuple[np.ndarray, bool]:
        """Wait on the packed ``[done/exhausted, n_valid, Y_next]`` buffer
        and charge the round at its true seed count.  Returns ``(Y_next,
        flag)`` with :meth:`step_ganter`'s contract."""
        tr = obs.current()
        with tr.span(f"spec/reconcile[{spec.seq}]") as sp:
            host = self._download_packed(spec)
            self.engine.charge_round(spec.cap, int(host[1]))
            sp.set(outcome="adopt")
        tr.end_async(f"mine/round[{spec.seq}]", spec.seq, outcome="adopt")
        self.engine.stats.observe_latency("round", time.perf_counter() - spec.t_dispatch)
        return host[2:], bool(host[0])
