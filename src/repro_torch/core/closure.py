"""Derivation and closure operators over packed bitset contexts.

Two interchangeable backends:
  * numpy  — host-side, used by the centralized baselines (NextClosure,
             CloseByOne) and as the ultimate oracle in tests;
  * torch  — device-side, on int32 views of the packed words, used by the
             MR* engines and mirrored by the CUDA kernel
             (``repro_torch.kernels``).

All functions share the padding discipline documented in
``repro.core.context.FormalContext.padded_rows``: padded object rows are
all-ones (AND-identity; they match every candidate, so supports are corrected
by the pad count), and results are masked with ``attr_mask`` so padded
attribute bits never leak.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.kernels.closure import and_reduce as _and_reduce  # noqa: F401
from repro_torch.kernels.closure import closure_plain

# ---------------------------------------------------------------------------
# numpy backend (host / oracle)
# ---------------------------------------------------------------------------


def extent_np(rows: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """``Y' `` — bool mask over objects whose row contains ``cand``. [N]"""
    return np.all((rows & cand) == cand, axis=-1)


def closure_np(
    rows: np.ndarray, cand: np.ndarray, attr_mask: np.ndarray
) -> tuple[np.ndarray, int]:
    """``Y''`` and ``|Y'|`` for a single packed candidate ``[W]``."""
    match = extent_np(rows, cand)
    sel = rows[match]
    if sel.shape[0] == 0:
        return attr_mask.copy(), 0
    return np.bitwise_and.reduce(sel, axis=0) & attr_mask, int(match.sum())


def batched_closure_np(
    rows: np.ndarray, cands: np.ndarray, attr_mask: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Batched ``Y''`` / supports.  rows [N,W], cands [B,W] → ([B,W], [B]).

    Memory O(B·N·W); chunk over B for very large batches.
    """
    out_c = np.empty_like(cands)
    out_s = np.empty(cands.shape[0], dtype=np.int64)
    # Chunk to bound the [b, N, W] intermediate at ~64 MB.
    nw = max(1, rows.shape[0] * rows.shape[1])
    chunk = max(1, int(16e6 // nw))
    full = np.uint32(0xFFFFFFFF)
    for lo in range(0, cands.shape[0], chunk):
        c = cands[lo : lo + chunk]
        match = np.all((rows[None, :, :] & c[:, None, :]) == c[:, None, :], axis=-1)
        sel = np.where(match[:, :, None], rows[None, :, :], full)
        out_c[lo : lo + chunk] = np.bitwise_and.reduce(sel, axis=1) & attr_mask
        out_s[lo : lo + chunk] = match.sum(axis=1)
    return out_c, out_s


def intent_of_extent_np(
    rows: np.ndarray, extent: np.ndarray, attr_mask: np.ndarray
) -> np.ndarray:
    """``X'`` — intent of a bool object mask ``[N]``."""
    sel = rows[extent]
    if sel.shape[0] == 0:
        return attr_mask.copy()
    return np.bitwise_and.reduce(sel, axis=0) & attr_mask


# ---------------------------------------------------------------------------
# torch backend (device)
# ---------------------------------------------------------------------------


def extent_torch(rows: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``Y'`` on device — bool mask over objects whose row contains ``cand``."""
    return ((rows & cand) == cand).all(-1)


def batched_closure_torch(
    rows: torch.Tensor, cands: torch.Tensor, attr_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched closure on device — the function K1 must match.

    rows [N, W] int32 (padded rows all-ones), cands [B, W] int32.
    Returns (closures [B, W] masked, raw supports [B] int32 — *including*
    all-ones padding rows; callers subtract the pad count).
    """
    closures, supports = closure_plain(rows, cands)
    return closures & attr_mask, supports


def closure_properties_hold(
    rows: np.ndarray, y: np.ndarray, attr_mask: np.ndarray
) -> bool:
    """Check extensive/idempotent for one candidate (test helper)."""
    c1, _ = closure_np(rows, y & attr_mask, attr_mask)
    c2, _ = closure_np(rows, c1, attr_mask)
    extensive = bool(np.all((y & attr_mask) & ~c1 == 0))
    idempotent = bool(np.array_equal(c1, c2))
    return extensive and idempotent
