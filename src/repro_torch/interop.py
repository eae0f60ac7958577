"""Hand a context across from the reference's numpy arrays and back.

The parity tests build one context with the reference and feed the very
same rows to the port through :func:`context_from_arrays`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.context import FormalContext


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
