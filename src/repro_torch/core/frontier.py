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

and only the surviving closures and their counts cross to the host.  On
``backend="kernel"`` engines the step variants run K2 (closure, support
and filter in one kernel pass); on ``backend="torch"`` they run the plain
closure followed by the same filters as torch ops.  Both give the same
rows in the same order.

Every sort that orders rows sorts on unsigned keys (``x ^ INT32_MIN`` on
the int32 view) and is stable, so the row order matches the reference's
uint32 order bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import lectic
from repro_torch.device import device_bits, host_bits, unsigned_key
from repro_torch.kernels import frontier as fkern
from repro_torch.kernels import ops

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


def _sort_unique(seeds: torch.Tensor, valid: torch.Tensor, *arrays) -> tuple:
    """Lexsort packed rows, mark adjacent duplicates, compact survivors.

    Invalid rows sort to the end (primary key), then word 0 down to word
    W-1 as unsigned keys — a stable least-significant-first radix pass per
    key.  Returns ``(count, seeds, *arrays)`` with the unique valid rows
    moved to the front.
    """
    perm = torch.arange(seeds.shape[0], device=seeds.device)
    for w in reversed(range(seeds.shape[1])):
        perm = perm[_stable_order(unsigned_key(seeds[perm, w]))]
    perm = perm[_stable_order((~valid[perm]).to(torch.uint8))]
    seeds = seeds[perm]
    valid = valid[perm]
    same_prev = (seeds == seeds.roll(1, 0)).all(-1)
    same_prev[:1] = False
    keep = valid & ~(same_prev & valid.roll(1))
    return _compact(keep, seeds, *(a[perm] for a in arrays))


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
        LOW = device_bits(t.LOW, engine.device)
        BIT = device_bits(t.BIT, engine.device)
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
        }
        # backend="kernel": every batched step variant runs K2 (closure →
        # support → driver filter in one pass).  The single-intent ganter
        # walks keep the spmd_step builders — their map runs K1, and their
        # argmax-select has no batch filter to fuse.
        if engine.backend == "kernel":
            for v in fkern.VARIANTS:
                builders[v] = lambda v=v: engine.spmd_step_fused(v, LOW)
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
        dev = self.engine.device
        self._frontier = device_bits(buf, dev)
        st = self.engine.stats
        st.h2d_transfers += 1
        st.h2d_bytes += buf.nbytes
        if gens is not None:
            gbuf = np.zeros((cap,), np.int32)
            gbuf[:n] = gens
            self._gens = torch.from_numpy(gbuf).to(dev)
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
                "adopting would silently drop concepts"
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
        t0 = time.perf_counter()
        seeds, n_dev = expand_oplus(
            self._frontier, self._n, self.LOW, self.BIT,
            n_attrs=self.n_attrs, dedupe=dedupe,
        )
        self.engine.stats.dispatch_s += time.perf_counter() - t0
        n_seeds = self._block_scalar(n_dev)  # sizes the rounds to the prune
        if n_seeds == 0:
            return np.zeros((0, self.W), np.uint32)
        parts = self._oplus_chunks(seeds, n_seeds, min_support=min_support)
        return np.concatenate(parts, axis=0)

    def _oplus_chunks(self, seeds, n_seeds: int, *, min_support: int | None):
        """Close seeds ``[0, n_seeds)`` in ``max_batch`` chunks, one round
        each, downloading every chunk's survivors."""
        eng = self.engine
        parts = []
        first = True
        for lo in range(0, n_seeds, eng.max_batch):
            b = min(eng.max_batch, n_seeds - lo)
            cap = ops.bucket_size(b, minimum=eng.min_bucket)
            chunk = slice_pad(seeds, lo, cap)
            t0 = time.perf_counter()
            if min_support is not None:
                name = "iceberg_unique" if self.dedupe_closures else "iceberg"
                cl, k_dev = self._step_fn(name)(eng.rows, chunk, b, min_support)
                eng.stats.dispatch_s += time.perf_counter() - t0
                eng.charge_round(cap, b, count_round=first)
                parts.append(self._download(cl, self._block_scalar(k_dev)))
            elif self.dedupe_closures:
                cl, k_dev = self._step_fn("unique")(eng.rows, chunk, b)
                eng.stats.dispatch_s += time.perf_counter() - t0
                eng.charge_round(cap, b, count_round=first)
                parts.append(self._download(cl, self._block_scalar(k_dev)))
            else:
                closures = self._step_fn("plain")(eng.rows, chunk)
                eng.stats.dispatch_s += time.perf_counter() - t0
                eng.charge_round(cap, b, count_round=first)
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
            seeds, parents, gen, n_seeds, min_support=min_support
        )
        n_new = sum(counts)
        if n_new == 0:
            self._n = 0
            return np.zeros((0, self.W), np.uint32), n_seeds, 0
        z_all = surv_z[0] if len(surv_z) == 1 else torch.cat(surv_z)
        g_all = surv_g[0] if len(surv_g) == 1 else torch.cat(surv_g)
        self._adopt(z_all, g_all, n_new)
        return self._download(self._frontier, n_new), n_seeds, n_new

    def _cbo_chunks(self, seeds, parents, gen, n_seeds: int, *, min_support):
        """Close+canonicity for CbO seeds ``[0, n_seeds)`` in ``max_batch``
        chunks.  Returns device survivor buffers ``(z_list, g_list,
        k_list)``."""
        eng = self.engine
        surv_z, surv_g, counts = [], [], []
        first = True
        for lo in range(0, n_seeds, eng.max_batch):
            b = min(eng.max_batch, n_seeds - lo)
            cap = ops.bucket_size(b, minimum=eng.min_bucket)
            args = (
                eng.rows,
                slice_pad(seeds, lo, cap),
                slice_pad(parents, lo, cap),
                slice_pad(gen, lo, cap),
                b,
            )
            t0 = time.perf_counter()
            if min_support is not None:
                z, g, k_dev = self._step_fn("cbo_iceberg")(*args, min_support)
            else:
                z, g, k_dev = self._step_fn("cbo")(*args)
            eng.stats.dispatch_s += time.perf_counter() - t0
            eng.charge_round(cap, b, count_round=first)
            first = False
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
        """
        eng = self.engine
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
        eng.charge_round(cap, self._block_scalar(valid[0].sum(dtype=torch.int32)))
        Y_host = self._download(Y_next[None, :], 1)[0]
        return Y_host, bool(self._block_scalar(done))
