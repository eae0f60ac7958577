"""Ganter's NextClosure (Algorithms 1–2 of the paper), centralized.

Two equivalent drivers are provided:

* ``next_closure`` / ``all_closures``  — the faithful scalar algorithm:
  scan attributes from p_m down to p_1, compute one ⊕ at a time, stop at the
  first feasible candidate.  This is the paper's Algorithm 2, verbatim.

* ``all_closures_batched`` — a vectorized variant that computes *all* m
  candidate closures of an iteration in one batched call and then picks the
  largest feasible attribute.  Bit-identical output (the first feasible
  candidate scanning downward == the feasible candidate with the largest
  generator), and it is exactly the compute shape of MRGanter's map phase,
  so the centralized and distributed code paths share arithmetic.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import bitset, closure, lectic
from repro_torch.core.context import FormalContext


def first_closure(ctx: FormalContext) -> np.ndarray:
    """``∅''`` — the lectically smallest intent (Algorithm 1, line 1)."""
    empty = np.zeros(ctx.W, dtype=np.uint32)
    c, _ = closure.closure_np(ctx.rows, empty, ctx.attr_mask())
    return c


def next_closure(
    ctx: FormalContext, Y: np.ndarray, tables: lectic.LecticTables | None = None
) -> np.ndarray | None:
    """The next intent after ``Y`` in lectic order, or None if ``Y`` is last."""
    tables = tables or lectic.LecticTables(ctx.n_attrs)
    mask = ctx.attr_mask()
    member = bitset.unpack_bits(Y, ctx.n_attrs)
    for a in range(ctx.n_attrs - 1, -1, -1):  # p_m down to p_1
        if member[a]:
            continue
        seed = lectic.oplus_seed(Y, a, tables)
        cand, _ = closure.closure_np(ctx.rows, seed, mask)
        if lectic.feasible(cand, Y, a, tables):
            return cand
    return None


def all_closures(ctx: FormalContext) -> list[np.ndarray]:
    """All intents in ascending lectic order (Algorithm 1)."""
    tables = lectic.LecticTables(ctx.n_attrs)
    Y = first_closure(ctx)
    out = [Y]
    full = ctx.attr_mask()
    while not np.array_equal(Y, full):
        Y = next_closure(ctx, Y, tables)
        assert Y is not None, "NextClosure must terminate at the full set"
        out.append(Y)
    return out


def all_closures_batched(ctx: FormalContext) -> list[np.ndarray]:
    """Vectorized AllClosure — one batched closure call per concept."""
    tables = lectic.LecticTables(ctx.n_attrs)
    mask = ctx.attr_mask()
    Y = first_closure(ctx)
    out = [Y]
    full = mask
    while not np.array_equal(Y, full):
        seeds, valid = lectic.oplus_seeds_all(Y, tables)
        cands, _ = closure.batched_closure_np(ctx.rows, seeds, mask)
        ok = lectic.feasible_batch(cands, Y, tables) & valid
        a = int(np.max(np.nonzero(ok)[0]))  # first feasible scanning downward
        Y = cands[a]
        out.append(Y)
    return out


def extents_for_intents(
    ctx: FormalContext, intents: list[np.ndarray]
) -> list[np.ndarray]:
    """Recover extents (bool [N]) for a list of intents — one final pass."""
    return [closure.extent_np(ctx.rows, y) for y in intents]
