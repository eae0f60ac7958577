"""Incremental concept maintenance (Godin-style object addition) — the
host half, a numpy copy of the reference's ``core/incremental.py``.

The paper's §1.1 motivates incremental algorithms: "batch algorithms …
require that the entire lattice is reconstructed from scratch if the
database changes."  This module closes that gap for the streaming case:

    intents' = intents ∪ { B ∩ Y_g : B ∈ intents }

— adding object ``g`` with intent ``Y_g`` can only create concepts whose
intents are intersections of old intents with ``Y_g`` (every other closure
is unchanged; extents of intents ⊆ Y_g silently gain ``g``).  One pass,
O(|F|·W) word-ops, vectorized over the whole intent set — no mining rerun.

``add_objects`` is the batched one-pass version: the K new rows contribute
at most ``|P|`` distinct *subset intersections* (``P = {⋂ S : ∅ ≠ S ⊆ R}``,
computed by a K-step fold over the small ``P`` set), and the grown intent
set is exactly ``unique(intents ∪ (intents ∩ P) ∪ P)`` — one all-pairs
intersect (chunked to bound the temporary) and one ``np.unique``, instead
of K sequential passes over the full intent table.  (For a *closed* seed
set the ``∪ P`` term is already covered: ``M`` is always an intent and
``M ∩ p = p``.)  The per-row
``add_object`` loop is kept as the oracle (``add_objects_sequential``);
equivalence with it and with batch NextClosure on the grown context is
held against the reference (tests/test_torch_stream.py).  The device
twin lives in :mod:`repro_torch.query.stream`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.context import FormalContext


def add_object(
    ctx: FormalContext, intents: np.ndarray, new_row: np.ndarray
) -> tuple[FormalContext, np.ndarray]:
    """intents [C, W] (any order) + one packed row [W] → updated pair."""
    new_row = np.asarray(new_row, dtype=np.uint32)
    if np.any(new_row & ~ctx.attr_mask()):
        raise ValueError("new object has attribute bits above n_attrs")

    inter = intents & new_row[None, :]  # candidate new intents
    combined = np.concatenate([intents, inter, new_row[None, :]], axis=0)
    new_intents = np.unique(combined, axis=0)

    new_ctx = FormalContext(
        rows=np.concatenate([ctx.rows, new_row[None, :]], axis=0),
        n_objects=ctx.n_objects + 1,
        n_attrs=ctx.n_attrs,
        attr_names=ctx.attr_names,
    )
    return new_ctx, new_intents


def row_intersections(rows: np.ndarray) -> np.ndarray:
    """All distinct non-empty-subset intersections ``{⋂ S : ∅ ≠ S ⊆ rows}``.

    The fold dedupes after every row, so the result never exceeds the
    number of *distinct* intersections — bounded by the concept count of
    the K-row subcontext, not 2^K.  Returns [P, W] uint32.
    """
    rows = np.asarray(rows, dtype=np.uint32)
    P = rows[:1]
    for i in range(1, rows.shape[0]):
        r = rows[i][None, :]
        P = np.unique(np.concatenate([P, P & r, r]), axis=0)
    return P


def as_intent_array(intents) -> np.ndarray:
    return np.asarray(
        np.stack(intents) if isinstance(intents, list) else intents,
        dtype=np.uint32,
    )


def add_objects(
    ctx: FormalContext, intents, rows: np.ndarray
) -> tuple[FormalContext, np.ndarray]:
    """Batched object addition: one all-pairs intersect + one ``np.unique``.

    Equivalent to streaming ``rows`` through ``add_object`` one at a time
    (``add_objects_sequential``, the property-test oracle) — the grown
    intent set is ``intents ∪ (intents ∩ P) ∪ P`` with ``P`` the new rows'
    subset intersections — but the full intent table is touched once, not
    K times.
    """
    cur = as_intent_array(intents)
    rows = np.asarray(rows, dtype=np.uint32)
    if rows.shape[0] == 0:
        return ctx, cur
    if np.any(rows & ~ctx.attr_mask()):
        raise ValueError("new objects have attribute bits above n_attrs")
    P = row_intersections(rows)
    # Chunk the |F|×|P| product so the temporary stays ~64 MB regardless
    # of intent-table size; per-chunk np.unique keeps the final merge
    # bounded by (distinct per chunk) × n_chunks, not the raw product.
    chunk = max(1, int(16e6 // max(1, P.shape[0] * ctx.W)))
    parts = [cur, P]
    for lo in range(0, cur.shape[0], chunk):
        cand = (cur[lo : lo + chunk, None, :] & P[None, :, :]).reshape(
            -1, ctx.W
        )
        parts.append(np.unique(cand, axis=0))
    new_intents = np.unique(np.concatenate(parts, axis=0), axis=0)
    new_ctx = FormalContext(
        rows=np.concatenate([ctx.rows, rows], axis=0),
        n_objects=ctx.n_objects + rows.shape[0],
        n_attrs=ctx.n_attrs,
        attr_names=ctx.attr_names,
    )
    return new_ctx, new_intents


def add_objects_sequential(
    ctx: FormalContext, intents, rows: np.ndarray
) -> tuple[FormalContext, np.ndarray]:
    """Stream a batch of packed rows [K, W] through ``add_object`` one at a
    time — the paper-literal path, kept as ``add_objects``'s oracle."""
    cur = as_intent_array(intents)
    for i in range(rows.shape[0]):
        ctx, cur = add_object(ctx, cur, rows[i])
    return ctx, cur
