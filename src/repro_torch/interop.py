"""Hand state across from the reference's numpy arrays and back.

The parity tests build one context with the reference and feed the very
same rows to the port through :func:`context_from_arrays`; a rule table
crosses through :func:`basis_from_arrays`, so the rule-serving kernels
can be held against the reference on one and the same table.  A concept
store needs no helper: ``ConceptStore.build(ctx, intents)`` takes numpy
intents.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.context import FormalContext
from repro_torch.rules.basis import RuleBasis, RuleSet


def context_from_arrays(
    rows_u32: np.ndarray, n_objects: int, n_attrs: int
) -> FormalContext:
    """The port's :class:`FormalContext` over packed ``uint32`` rows."""
    return FormalContext(
        rows=np.array(rows_u32, dtype=np.uint32, copy=True),
        n_objects=int(n_objects),
        n_attrs=int(n_attrs),
    )


def to_numpy(ctx: FormalContext) -> tuple[np.ndarray, int, int]:
    """``(rows_u32, n_objects, n_attrs)`` of a port context."""
    return np.array(ctx.rows, dtype=np.uint32, copy=True), ctx.n_objects, ctx.n_attrs


def basis_from_arrays(
    premise: np.ndarray,
    added: np.ndarray,
    support: np.ndarray,
    confidence: np.ndarray,
    lift: np.ndarray,
    n_implications: int,
    *,
    n_objects: int,
    n_attrs: int,
    min_conf: float,
) -> RuleBasis:
    """The port's :class:`RuleBasis` over a combined rule table: the first
    ``n_implications`` rows are the implications, the rest the partial
    rules (the layout of the reference's ``RuleBasis.combined()``).
    Every array is copied, in the dtypes the port's ``RuleSet`` holds."""
    arrays = (
        np.array(premise, dtype=np.uint32, copy=True),
        np.array(added, dtype=np.uint32, copy=True),
        np.array(support, dtype=np.int32, copy=True),
        np.array(confidence, dtype=np.float32, copy=True),
        np.array(lift, dtype=np.float32, copy=True),
    )
    n = int(n_implications)
    return RuleBasis(
        n_objects=int(n_objects),
        n_attrs=int(n_attrs),
        min_conf=float(min_conf),
        implications=RuleSet(*(a[:n] for a in arrays)),
        partial=RuleSet(*(a[n:] for a in arrays)),
    )
