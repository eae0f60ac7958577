"""The MR* miners: MRGanter, MRGanter+ and MRCbo (paper §3), as iterative
drivers over a :class:`repro_torch.core.engine.ClosureEngine`.

Each driver is the Twister control loop: the engine holds the static data
(the context rows, resident on the device); the *dynamic data* — the
frontier of previous intents — crosses the host/device boundary once per
iteration, exactly like Twister re-configuring its long-running map tasks
with the previous iteration's closures.

Two frontier substrates (``pipeline=``):

  * ``"device"`` (default) — the device-resident pipeline of
    :mod:`repro_torch.core.frontier`: seed expansion, dedupe/canonicity
    and feasibility all run on the device; the host loop is convergence
    control plus the global registry.
  * ``"host"`` — the paper-literal host loop (per-intent Python seed
    building, per-row hash inserts), kept as the equivalence oracle.

Both substrates produce identical concept sets; MRGanter additionally
preserves exact lectic emission order on both.

Iteration counts follow the paper's convention (Table 9): every map/reduce
round over the full context counts as one iteration, including the round
that computes ``∅''`` and, for MRGanter+/MRCbo, the final round that proves
the frontier is exhausted.

On a 2-D plan (``ShardPlan.cand_parts > 1``) MRGanter+ and MRCbo absorb
``cand_parts × max_batch`` candidates per round by blocking each chunk over
the candidate axis; MRGanter's single-intent frontier stays 1-D.  Each
public driver records its run as the root span ``mine/<algorithm>`` on the
current tracer (:mod:`repro_torch.obs`).

Round scheduling on the device pipeline (``rounds=``): ``"sync"`` reads
every round's survivor count on the host before it dispatches the next
(the bit-exact oracle); ``"async"`` dispatches round r+1 against round
r's unreconciled survivor buffer, its count chained on the device, and
reconciles round r only once round r+1 is in flight
(``DeviceFrontier.spec_*`` / ``reconcile_*``).  Concept sets and iteration
counts are the same in both modes; the per-round census may differ (a
speculative chunk is padded to its coverage before the true count is
known).
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core import bitset, lectic
from repro_torch.core.engine import ClosureEngine
from repro_torch.core.frontier import DeviceFrontier
from repro_torch.core.hashindex import TwoLevelHash
from repro_torch.obs import trace as obs

PIPELINES = ("device", "host")
ROUNDS = ("sync", "async")


@dataclasses.dataclass
class MRResult:
    intents: list[np.ndarray]
    n_iterations: int
    n_closures_computed: int
    modeled_comm_bytes: int
    wall_time_s: float
    algorithm: str
    # iceberg runs record their (absolute) threshold; None == full lattice
    min_support: int | None = None

    @property
    def n_concepts(self) -> int:
        return len(self.intents)


def _traced_driver(algo: str):
    """Wrap a public MR* driver in the run's root trace span, tagged with
    its pipeline and rounds mode; with the no-op tracer (the default) the
    wrapper costs one dict per mine."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with obs.current().span(
                f"mine/{algo}",
                pipeline=kwargs.get("pipeline", "device"),
                rounds=kwargs.get("rounds", "sync"),
            ):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _seeds_for(Y: np.ndarray, tables: lectic.LecticTables) -> np.ndarray:
    seeds, valid = lectic.oplus_seeds_all(Y, tables)
    return seeds[valid]


def _check_rounds(rounds: str, pipeline: str):
    if rounds not in ROUNDS:
        raise ValueError(f"unknown rounds mode {rounds!r}; choose {ROUNDS}")
    if rounds == "async" and pipeline != "device":
        raise ValueError(
            "rounds='async' requires pipeline='device' — the host loop has "
            "no device futures to overlap"
        )


def _check_modes(pipeline: str, rounds: str):
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; choose {PIPELINES}")
    _check_rounds(rounds, pipeline)


def _result(
    engine: ClosureEngine, intents, n_iter, t0, algorithm, min_support=None
) -> MRResult:
    return MRResult(
        intents=intents,
        n_iterations=n_iter,
        n_closures_computed=engine.stats.closures_computed,
        modeled_comm_bytes=engine.stats.modeled_comm_bytes,
        wall_time_s=time.perf_counter() - t0,
        algorithm=algorithm,
        min_support=min_support,
    )


def _check_min_support(min_support: int | None) -> int | None:
    """Validate and normalize the iceberg threshold (absolute count)."""
    if min_support is None:
        return None
    s = int(min_support)
    if s != min_support or s < 1:
        raise ValueError(
            f"min_support must be a positive object count, got {min_support!r}"
            " (use repro_torch.rules.resolve_min_support for fractional"
            " thresholds)"
        )
    return s


# ---------------------------------------------------------------------------
# MRGanter (Algorithms 4 + 5): strict lectic order, one concept/iteration.
# ---------------------------------------------------------------------------


@_traced_driver("mrganter")
def mrganter(
    ctx,
    engine: ClosureEngine,
    max_iterations: int | None = None,
    *,
    pipeline: str = "device",
    min_support: int | None = None,
    rounds: str = "sync",
) -> MRResult:
    """``min_support`` mines the iceberg lattice in strict lectic order:
    the Alg.-5 scan restricts to frequent successors.  The next *frequent*
    closure after Y is Y ⊕ a for the largest feasible frequent a, so the
    jump skips infrequent closures without ever visiting them.

    ``rounds="async"`` chains the Alg.-5 steps on the device: each step's
    selected intent is broadcast into the frontier slot at dispatch, step
    r+1 is dispatched before step r's packed readback is awaited, and a
    step dispatched past the walk's true end is discarded unread.  The
    emission order stays exactly lectic."""
    _check_modes(pipeline, rounds)
    min_support = _check_min_support(min_support)
    t0 = time.perf_counter()
    full = ctx.attr_mask()
    Y, s0 = engine.first_closure()
    if min_support is not None and s0 < min_support:
        return _result(engine, [], 1, t0, "mrganter", min_support)
    intents = [Y]
    n_iter = 1

    if pipeline == "device" and rounds == "async":
        return _mrganter_async(engine, Y, full, intents, n_iter, t0,
                               max_iterations=max_iterations, min_support=min_support)

    if pipeline == "device":
        fr = DeviceFrontier(engine)
        fr.set_frontier(Y[None, :])
        if min_support is None:
            done = np.array_equal(Y, full)
            while not done:
                if max_iterations is not None and n_iter >= max_iterations:
                    break
                Y, done = fr.step_ganter()
                intents.append(Y)
                n_iter += 1
            return _result(engine, intents, n_iter, t0, "mrganter")
        while not np.array_equal(Y, full):
            if max_iterations is not None and n_iter >= max_iterations:
                break
            Y, exhausted = fr.step_ganter(min_support=min_support)
            n_iter += 1  # the exhausting scan is a map/reduce round too
            if exhausted:
                break
            intents.append(Y)
        return _result(engine, intents, n_iter, t0, "mrganter", min_support)

    tables = lectic.LecticTables(ctx.n_attrs)
    while not np.array_equal(Y, full):
        if max_iterations is not None and n_iter >= max_iterations:
            break
        # Map: local closures for every attribute p_i ∉ d (Alg. 4).
        seeds, valid = lectic.oplus_seeds_all(Y, tables)
        closures, sups = engine.closure(seeds)  # Reduce: Theorem-2 intersection
        # Feasibility ≤_{p_i} (Alg. 5): first success scanning p_m → p_1.
        ok = lectic.feasible_batch(closures, Y, tables) & valid
        if min_support is not None:
            ok &= sups >= min_support
        if min_support is not None and not ok.any():
            n_iter += 1  # the exhausting scan
            break
        Y_t, found = lectic.select_lectic(
            torch.from_numpy(closures.view(np.int32)), torch.from_numpy(ok)
        )
        if not bool(found):
            raise RuntimeError("NextClosure invariant broken: no feasible successor")
        Y = Y_t.numpy().view(np.uint32).copy()
        intents.append(Y)
        n_iter += 1
    return _result(engine, intents, n_iter, t0, "mrganter", min_support)


def _mrganter_async(engine, Y, full, intents, n_iter, t0, *, max_iterations, min_support):
    """MRGanter's round loop around futures: step r is reconciled only once
    step r+1 is in flight."""
    fr = DeviceFrontier(engine)
    fr.set_frontier(Y[None, :])
    capped = max_iterations is not None and n_iter >= max_iterations
    pending = (None if np.array_equal(Y, full) or capped
               else fr.spec_ganter(min_support=min_support))
    while pending is not None:
        speculate = max_iterations is None or n_iter + 1 < max_iterations
        nxt = fr.spec_ganter(min_support=min_support) if speculate else None
        Y, flag = fr.reconcile_ganter(pending)
        n_iter += 1  # an exhausting iceberg scan is a map/reduce round too
        if min_support is None:
            intents.append(Y)
            stop = flag  # reached the top
        else:
            if not flag:  # flag: no frequent successor; Y is garbage
                intents.append(Y)
            stop = flag or np.array_equal(Y, full)
        if stop or nxt is None:
            fr.discard_spec(nxt)
            break
        pending = nxt
    return _result(engine, intents, n_iter, t0, "mrganter", min_support)


# ---------------------------------------------------------------------------
# MRGanter+ (Algorithms 4 + 6): keep all new closures, dedupe via the
# two-level hash; iterations collapse to ~lattice depth.
# ---------------------------------------------------------------------------


@_traced_driver("mrganter_plus")
def mrganter_plus(
    ctx,
    engine: ClosureEngine,
    *,
    dedupe_candidates: bool = False,
    dedupe_closures: bool = False,
    local_prune: bool | None = None,
    max_iterations: int | None = None,
    pipeline: str = "device",
    min_support: int | None = None,
    rounds: str = "sync",
) -> MRResult:
    """``dedupe_candidates=False`` is the paper-literal map phase (every
    frontier intent emits a candidate for every absent attribute).  ``True``
    drops duplicate *seeds* before the closure — the paper's per-partition
    local pruning (device pipeline: the on-device unsigned lexsort +
    adjacent-unique stage; host loop: ``np.unique``).  Same output either
    way.  ``local_prune`` is the paper-facing alias for the same switch
    (it wins when both are given).

    ``min_support`` mines the iceberg lattice: closures below the
    threshold are compacted away right after the support count and never
    join the frontier.  Lossless: each frequent closed Z ≠ ∅'' equals
    closure(D ⊕ a) for a frequent closed proper subset D.

    ``rounds="async"`` keeps round r's survivor buffer on the device and
    dispatches round r+1's expansion against it before round r's counts
    are read back; the host registry reconciles novelty one round behind
    the device.  The async frontier is the round's unique closure set
    (novel and stale) rather than the novel subset: stale rows only
    regenerate closures registered in earlier rounds, so the novel set of
    each round, the concept set and the iteration count are those of sync.
    ``dedupe_closures`` is implied (the adopted slot is deduped, bounding
    the stale rows re-expanded).
    """
    _check_modes(pipeline, rounds)
    if local_prune is not None:
        dedupe_candidates = local_prune
    min_support = _check_min_support(min_support)
    t0 = time.perf_counter()
    H = TwoLevelHash()
    Y0, s0 = engine.first_closure()
    if min_support is not None and s0 < min_support:
        return _result(engine, [], 1, t0, "mrganter+", min_support)
    H.add(Y0)
    intents = [Y0]
    n_iter = 1

    if pipeline == "device" and rounds == "async":
        return _mrganter_plus_async(ctx, engine, H, Y0, intents, n_iter, t0,
                                    dedupe_candidates=dedupe_candidates,
                                    max_iterations=max_iterations, min_support=min_support)

    if pipeline == "device":
        fr = DeviceFrontier(engine, dedupe_closures=dedupe_closures)
        fr.set_frontier(Y0[None, :])
        while len(fr):
            if max_iterations is not None and n_iter >= max_iterations:
                break
            rounds_before = engine.stats.rounds
            uniq = fr.step_oplus(dedupe=dedupe_candidates, min_support=min_support)
            if uniq.shape[0] == 0:
                # an iceberg round can run and prune every closure — that
                # exhausting map/reduce round still counts (host parity)
                if engine.stats.rounds > rounds_before:
                    n_iter += 1
                break
            n_iter += 1
            new_idx = H.add_batch(uniq)  # global registry (vectorized)
            new = uniq[new_idx]
            intents.extend(new)
            if new.shape[0]:
                fr.set_frontier(new)  # the Twister dynamic delta, one upload
            else:
                fr.set_frontier(np.zeros((0, ctx.W), np.uint32))
        return _result(engine, intents, n_iter, t0, "mrganter+", min_support)

    tables = lectic.LecticTables(ctx.n_attrs)
    frontier = [Y0]
    while frontier:
        if max_iterations is not None and n_iter >= max_iterations:
            break
        seed_list = [_seeds_for(Y, tables) for Y in frontier]
        seeds = (
            np.concatenate(seed_list, axis=0)
            if seed_list
            else np.zeros((0, ctx.W), np.uint32)
        )
        if seeds.shape[0] == 0:
            break
        if dedupe_candidates:
            seeds = np.unique(seeds, axis=0)
        n_iter += 1
        closures, sups = engine.closure(seeds)
        if min_support is not None:
            closures = closures[sups >= min_support]
        new_idx = H.add_batch(closures)
        frontier = [closures[i] for i in new_idx]
        intents.extend(frontier)
    return _result(engine, intents, n_iter, t0, "mrganter+", min_support)


def _mrganter_plus_async(ctx, engine, H, Y0, intents, n_iter, t0, *,
                         dedupe_candidates, max_iterations, min_support):
    """MRGanter+'s round loop around futures.

    It stops where the sync loop stops: a reconciled round counts iff its
    true seed count was nonzero, and the walk ends when the registry finds
    no novel closure — or when the sole novel intent is the full attribute
    set, which has no ⊕-successors, so that sync's next expansion would be
    empty (the async frontier also holds stale rows, which sync would not
    expand, so this case is told apart on the host)."""
    full = ctx.attr_mask()
    fr = DeviceFrontier(engine, dedupe_closures=True)
    fr.set_frontier(Y0[None, :])

    def spec():
        return fr.spec_oplus(dedupe=dedupe_candidates, min_support=min_support)

    capped = max_iterations is not None and n_iter >= max_iterations
    pending = None if capped else spec()
    while pending is not None:
        speculate = max_iterations is None or n_iter + 1 < max_iterations
        nxt = spec() if speculate else None
        rec = fr.reconcile_oplus(pending, min_support=min_support)
        if rec.n_seeds == 0:  # no closure round ran: uncounted, as in sync
            fr.discard_spec(nxt)
            break
        n_iter += 1
        if rec.closures.shape[0] == 0:
            # an iceberg round pruned every closure: the exhausting round
            # still counts, as in sync
            fr.discard_spec(nxt)
            break
        new = rec.closures[H.add_batch(rec.closures)]
        intents.extend(new)
        sync_would_stop = new.shape[0] == 0 or (
            new.shape[0] == 1 and np.array_equal(new[0], full))
        if sync_would_stop or nxt is None:
            fr.discard_spec(nxt)
            break
        if rec.under_covered:
            # the round in flight chained on a partial frontier: discard it,
            # restore the true (novel) frontier and dispatch again
            fr.discard_spec(nxt)
            fr.set_frontier(new)
            nxt = spec()
        pending = nxt
    return _result(engine, intents, n_iter, t0, "mrganter+", min_support)


# ---------------------------------------------------------------------------
# MRCbo: distributed CloseByOne under the same engine (paper §5 baseline).
# ---------------------------------------------------------------------------


@_traced_driver("mrcbo")
def mrcbo(
    ctx,
    engine: ClosureEngine,
    max_iterations: int | None = None,
    *,
    pipeline: str = "device",
    min_support: int | None = None,
    rounds: str = "sync",
) -> MRResult:
    """``min_support`` prunes the CbO tree at infrequent nodes: intents
    only grow along the canonical generation path, so every frequent
    concept's ancestors are frequent and pruning is lossless.

    ``rounds="async"`` expands round r's canonical survivors while their
    count is still on the device.  The canonicity filter makes the survivor
    buffer exactly the next frontier (no registry lag), so a covered
    speculation is exact; under-coverage closes the uncovered tail
    synchronously and re-adopts the whole survivor set before speculating
    again."""
    _check_modes(pipeline, rounds)
    min_support = _check_min_support(min_support)
    t0 = time.perf_counter()
    root, s0 = engine.first_closure()
    if min_support is not None and s0 < min_support:
        return _result(engine, [], 1, t0, "mrcbo", min_support)
    intents = [root]
    n_iter = 1

    if pipeline == "device" and rounds == "async":
        return _mrcbo_async(engine, root, intents, n_iter, t0,
                            max_iterations=max_iterations, min_support=min_support)

    if pipeline == "device":
        fr = DeviceFrontier(engine)
        fr.set_frontier(root[None, :], gens=np.array([-1], np.int32))
        while len(fr):
            if max_iterations is not None and n_iter >= max_iterations:
                break
            # canonicity filter IS the dedupe; iceberg adds the support cut
            new, n_seeds, _ = fr.step_cbo(min_support=min_support)
            if n_seeds == 0:  # frontier exhausted before any closure round
                break
            n_iter += 1
            intents.extend(new)
        return _result(engine, intents, n_iter, t0, "mrcbo", min_support)

    tables = lectic.LecticTables(ctx.n_attrs)
    frontier: list[tuple[np.ndarray, int]] = [(root, -1)]
    while frontier:
        if max_iterations is not None and n_iter >= max_iterations:
            break
        seeds, parents, gens = [], [], []
        for Y, g in frontier:
            member = bitset.unpack_bits(Y, ctx.n_attrs)
            for a in range(g + 1, ctx.n_attrs):
                if not member[a]:
                    seeds.append(Y | tables.BIT[a])
                    parents.append(Y)
                    gens.append(a)
        if not seeds:
            break
        n_iter += 1
        closures, sups = engine.closure(np.stack(seeds))
        next_frontier = []
        for i in range(closures.shape[0]):
            a, Y, Z = gens[i], parents[i], closures[i]
            if min_support is not None and sups[i] < min_support:
                continue
            if np.all(((Z ^ Y) & tables.LOW[a]) == 0):  # CbO canonicity
                intents.append(Z)
                next_frontier.append((Z, a))
        frontier = next_frontier
    return _result(engine, intents, n_iter, t0, "mrcbo", min_support)


def _mrcbo_async(engine, root, intents, n_iter, t0, *, max_iterations, min_support):
    """MRCbo's round loop around futures (see :func:`mrcbo`)."""
    fr = DeviceFrontier(engine)
    fr.set_frontier(root[None, :], gens=np.array([-1], np.int32))
    capped = max_iterations is not None and n_iter >= max_iterations
    pending = None if capped else fr.spec_cbo(min_support=min_support)
    while pending is not None:
        speculate = max_iterations is None or n_iter + 1 < max_iterations
        nxt = fr.spec_cbo(min_support=min_support) if speculate else None
        rec = fr.reconcile_cbo(pending, min_support=min_support)
        if rec.n_seeds == 0:  # the frontier was exhausted before any round
            fr.discard_spec(nxt)
            break
        n_iter += 1
        intents.extend(rec.new_intents)
        if rec.n_new == 0 or nxt is None:
            fr.discard_spec(nxt)
            break
        if rec.under_covered:
            # the reconcile re-adopted the whole survivor set; the round in
            # flight ran on a partial frontier: discard it, dispatch again
            fr.discard_spec(nxt)
            nxt = fr.spec_cbo(min_support=min_support)
        pending = nxt
    return _result(engine, intents, n_iter, t0, "mrcbo", min_support)
