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

Rounds are synchronous: the host reads each round's survivor count before
it dispatches the next.  Speculative asynchronous rounds
(``rounds="async"`` in the reference) come with a later slice of the port
and raise ``NotImplementedError`` here.
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
ROUNDS = ("sync",)


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


def _check_modes(pipeline: str, rounds: str):
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}; choose {PIPELINES}")
    if rounds == "async":
        raise NotImplementedError(
            "rounds='async' (speculative rounds) is not ported yet: it comes "
            "with the async-rounds slice of repro_torch; use rounds='sync'"
        )
    if rounds not in ROUNDS:
        raise ValueError(f"unknown rounds mode {rounds!r}; choose {ROUNDS}")


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
    jump skips infrequent closures without ever visiting them."""
    _check_modes(pipeline, rounds)
    min_support = _check_min_support(min_support)
    t0 = time.perf_counter()
    full = ctx.attr_mask()
    Y, s0 = engine.first_closure()
    if min_support is not None and s0 < min_support:
        return _result(engine, [], 1, t0, "mrganter", min_support)
    intents = [Y]
    n_iter = 1

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
    concept's ancestors are frequent and pruning is lossless."""
    _check_modes(pipeline, rounds)
    min_support = _check_min_support(min_support)
    t0 = time.perf_counter()
    root, s0 = engine.first_closure()
    if min_support is not None and s0 < min_support:
        return _result(engine, [], 1, t0, "mrcbo", min_support)
    intents = [root]
    n_iter = 1

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
