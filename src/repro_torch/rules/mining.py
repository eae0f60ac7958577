"""Iceberg mining entry points: threshold resolution + driver dispatch.

The actual in-round pruning lives in the miners themselves
(:mod:`repro_torch.core.mr` ``min_support=``, applied right after the support count in
:mod:`repro_torch.core.frontier`); this module owns the user-facing threshold
vocabulary (absolute count or fraction of |O|) and the one-call mining
path the CLI shares.
"""

from __future__ import annotations

import math

from repro_torch.core.mr import MRResult, mrcbo, mrganter, mrganter_plus

ALGORITHMS = {
    "mrganter": mrganter,
    "mrganter+": mrganter_plus,
    "mrcbo": mrcbo,
}


def resolve_min_support(value, n_objects: int) -> int:
    """An absolute object count from a count-or-fraction spec.

    Fractions in (0, 1) resolve to ``ceil(value · n_objects)`` (≥ 1);
    values ≥ 1 must be whole counts.  The resolved count is what the
    miners and CLI stats speak.

    The ceiling snaps to the nearest integer when the product sits within
    floating-point noise of it: a fraction that lands *exactly* on an
    integer support must resolve to that integer, but binary floating
    point can nudge the product just above (e.g. ``0.07 * 100 ==
    7.000000000000001``) and a naive ``ceil`` would then silently drop
    every concept sitting exactly on the threshold boundary.  "Support ≥
    7" and "support ≥ 0.07·|O|" have to mean the same thing.  The snap
    tolerance is relative (1e-12 ≈ 4000 ulp — far above the few-ulp error
    of one divide+multiply, far below any meaningful fractional part), so
    genuinely fractional targets still round up at any |O|.
    """
    v = float(value)
    if not math.isfinite(v) or v <= 0:
        raise ValueError(f"min_support must be positive, got {value!r}")
    if v < 1:
        target = v * n_objects
        nearest = round(target)
        if nearest >= 1 and abs(target - nearest) <= 1e-12 * max(1.0, target):
            return int(nearest)
        return max(1, math.ceil(target))
    if v != int(v):
        raise ValueError(
            f"min_support ≥ 1 must be a whole object count, got {value!r}"
        )
    return int(v)


def mine_iceberg(
    ctx,
    engine,
    *,
    min_support,
    algorithm: str = "mrganter+",
    pipeline: str = "device",
    **kw,
) -> MRResult:
    """Mine the iceberg lattice at ``min_support`` (count or fraction).

    Dispatches to the chosen MR* driver with the threshold resolved to an
    absolute count; the pruning runs inside the drivers' rounds.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; choose {sorted(ALGORITHMS)}"
        )
    s = resolve_min_support(min_support, ctx.n_objects)
    return ALGORITHMS[algorithm](
        ctx, engine, pipeline=pipeline, min_support=s, **kw
    )
