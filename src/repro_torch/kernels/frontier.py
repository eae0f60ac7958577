"""K2: the fused frontier step — closure, support and driver filter in one
pass (single-object-shard plans).

Per candidate ``b`` of a chunk it computes

    closure[b] = (AND of matching context rows) & mask
    support[b] = #matching rows − n_pad
    keep[b]    = (b + row_off < n_valid)
                 ∧ [support[b] ≥ min_sup]                  (iceberg)
                 ∧ [((closure[b] ^ parent[b]) & lowrow[b]) == 0]   (cbo)

:func:`fused_step` launches the CUDA kernel in ``csrc/frontier.cu`` for
CUDA tensors and runs :func:`fused_step_plain` for CPU tensors.  The
scalars ``(n_valid, min_sup, n_pad, row_off)`` are plain ints passed at
launch, so no threshold or window forces a rebuild.  CbO's ``LOW[gen]``
gather stays with the caller (``lowrow``).  Survivor compaction stays in
torch (:mod:`repro_torch.core.frontier`): it consumes only the keep mask
and the closures.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.closure import (
    check_bitsets,
    check_closure_operands,
    closure_plain,
)

# scalar layout: (n_valid, min_sup, n_pad, row_off)
#   n_valid — valid candidate rows in the (whole-chunk) batch
#   min_sup — iceberg threshold (ignored unless iceberg=True)
#   n_pad   — all-ones context padding rows to subtract from supports
#   row_off — the block's first row's chunk-global index (0 on 1-D plans)
N_SCALARS = 4

# variant name -> (iceberg, cbo, unique) flags; the engine's fused step
# builders key off these, the drivers use the same names.
VARIANTS = {
    "plain": (False, False, False),
    "unique": (False, False, True),
    "iceberg": (True, False, False),
    "iceberg_unique": (True, False, True),
    "cbo": (False, True, False),
    "cbo_iceberg": (True, True, False),
}


def pack_scalars(n_valid, min_sup=0, n_pad=0, row_off=0) -> tuple[int, ...]:
    """The kernel's scalar operands as plain ints in the int32 range."""
    out = tuple(int(v) for v in (n_valid, min_sup, n_pad, row_off))
    for v in out:
        if not -(2**31) <= v < 2**31:
            raise ValueError(f"scalar {v} outside the int32 range")
    return out


def fused_step_plain(
    rows, cands, mask, scalars, *, parent=None, lowrow=None,
    iceberg: bool = False, cbo: bool = False,
):
    """The plain PyTorch version of K2: (closures, supports, keep)."""
    n_valid, min_sup, n_pad, row_off = scalars
    closures, supports = closure_plain(rows, cands)
    gc = closures & mask
    sup = supports - n_pad
    idx = torch.arange(cands.shape[0], device=cands.device) + row_off
    keep = idx < n_valid
    if iceberg:
        keep = keep & (sup >= min_sup)
    if cbo:
        keep = keep & (((gc ^ parent) & lowrow) == 0).all(-1)
    return gc, sup, keep


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier")
    lib.fused_step_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.fused_step_launch.restype = ctypes.c_int
    return lib


def fused_step(
    rows: torch.Tensor,
    cands: torch.Tensor,
    mask: torch.Tensor,
    scalars,
    *,
    parent: torch.Tensor | None = None,
    lowrow: torch.Tensor | None = None,
    iceberg: bool = False,
    cbo: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: masked closures [B, W], corrected supports [B], keep [B] bool.

    rows [N, W], cands [B, W] and mask [1, W] are int32 bitset blocks;
    ``scalars`` is :func:`pack_scalars`' tuple.  CbO variants also take
    parent/lowrow [B, W].  ``fused_step.launches`` counts kernel launches.
    """
    check_closure_operands(rows, cands)
    N, W = rows.shape
    B = cands.shape[0]
    check_bitsets("mask", mask, (1, W))
    if len(scalars) != N_SCALARS:
        raise ValueError(f"scalars must be (n_valid, min_sup, n_pad, row_off), got {scalars!r}")
    scalars = pack_scalars(*scalars)
    if cbo:
        if parent is None or lowrow is None:
            raise ValueError("cbo=True needs parent= and lowrow= operands")
        check_bitsets("parent", parent, (B, W))
        check_bitsets("lowrow", lowrow, (B, W))
    operands = [mask] + ([parent, lowrow] if cbo else [])
    for t in operands:
        if t.device != rows.device:
            raise ValueError(f"operand on {t.device}, rows on {rows.device}")
    if rows.device.type == "cpu":
        return fused_step_plain(
            rows, cands, mask, scalars, parent=parent, lowrow=lowrow,
            iceberg=iceberg, cbo=cbo,
        )
    out_c = torch.empty((B, W), dtype=torch.int32, device=rows.device)
    out_s = torch.empty((B,), dtype=torch.int32, device=rows.device)
    keep = torch.empty((B,), dtype=torch.bool, device=rows.device)
    if B == 0:
        return out_c, out_s, keep
    with torch.cuda.device(rows.device):
        rc = _lib().fused_step_launch(
            rows.data_ptr(), cands.data_ptr(), mask.data_ptr(),
            parent.data_ptr() if cbo else None,
            lowrow.data_ptr() if cbo else None,
            out_c.data_ptr(), out_s.data_ptr(), keep.data_ptr(),
            N, B, W, *scalars, int(iceberg), int(cbo),
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused step kernel launch failed: CUDA error {rc}")
    fused_step.launches += 1
    return out_c, out_s, keep


fused_step.launches = 0
