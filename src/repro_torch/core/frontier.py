"""Device-resident frontier pipeline for the MR* drivers (sync rounds).

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
``/filter`` (the survivor download).  Spans add no device synchronisation
of their own.

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
    block = torch.arange(nb, device=seeds.device).repeat_interleave(Bc)
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


def expand_oplus(frontier, n_valid: int, LOW, BIT, *, n_attrs: int, dedupe: bool):
    """⊕-expansion of a frontier [F, W] → compacted seeds [F·m, W] + count.

    ``dedupe=True`` is MRGanter+'s local pruning: duplicate seeds die here,
    before any round is sized (``dedupe_candidates``).
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


def expand_cbo(frontier, gens, n_valid: int, BIT, *, n_attrs: int):
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
    parent = torch.arange(F, dtype=torch.int32, device=dev).repeat_interleave(n_attrs)
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
            out = np.concatenate(
                self._oplus_chunks(seeds, n_seeds, min_support=min_support, seq=seq), axis=0
            )
            sp.set(n_seeds=n_seeds, survivors=int(out.shape[0]))
        self.engine.stats.observe_latency("round", time.perf_counter() - t_round)
        return out

    def _oplus_chunks(self, seeds, n_seeds: int, *, min_support: int | None, seq: int):
        """Close seeds ``[0, n_seeds)`` in ``round_budget`` chunks, one round
        each, downloading every chunk's survivors.  Every filter is
        row-wise, so chunk and block boundaries never change the surviving
        rows — only how many rounds produce them."""
        eng = self.engine
        tr = obs.current()
        pfx = f"mine/round[{seq}]"
        two_d = self.cand_parts > 1
        sfx = "2d" if two_d else ""
        parts = []
        first = True
        for lo in range(0, n_seeds, self.round_budget):
            b = min(self.round_budget, n_seeds - lo)
            cap, blk = self._chunk_caps(b)
            chunk = slice_pad(seeds, lo, cap)
            t0 = time.perf_counter()
            if min_support is not None or self.dedupe_closures:
                if min_support is None:
                    name, extra = "unique", ()
                else:
                    name = "iceberg_unique" if self.dedupe_closures else "iceberg"
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
            surv_z, surv_g, counts = self._cbo_chunks(
                seeds, parents, gen, n_seeds, min_support=min_support, seq=seq
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

    def _cbo_chunks(self, seeds, parents, gen, n_seeds: int, *, min_support, seq: int):
        """Close+canonicity for CbO seeds ``[0, n_seeds)`` in
        ``round_budget`` chunks.  Returns device survivor buffers ``(z_list,
        g_list, k_list)``."""
        eng = self.engine
        tr = obs.current()
        pfx = f"mine/round[{seq}]"
        two_d = self.cand_parts > 1
        name = ("cbo" if min_support is None else "cbo_iceberg") + ("2d" if two_d else "")
        extra = () if min_support is None else (min_support,)
        surv_z, surv_g, counts = [], [], []
        first = True
        for lo in range(0, n_seeds, self.round_budget):
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
                t0 = time.perf_counter()
                Y = self._frontier[0]
                seeds, valid = lectic.oplus_seeds_torch(
                    Y[None, :], self.LOW, self.BIT, self.n_attrs
                )
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
            with tr.span(f"mine/round[{seq}]/allreduce"):
                eng.charge_round(cap, self._block_scalar(valid[0].sum(dtype=torch.int32)))
            with tr.span(f"mine/round[{seq}]/filter"):
                Y_host = self._download(Y_next[None, :], 1)[0]
                flag = bool(self._block_scalar(done))
        eng.stats.observe_latency("round", time.perf_counter() - t_round)
        return Y_host, flag
