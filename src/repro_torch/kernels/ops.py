"""Public wrapper around K1 with the padding and correction discipline.

    closures, supports = batched_closure(rows, cands, n_attrs,
                                         n_valid_rows=N_real)

  * rows may carry pre-existing all-ones padding (``n_valid_rows`` real)
    and are padded with all-ones rows up to a multiple of ``block_n``;
  * candidates of any batch size are padded with all-ones rows up to a
    multiple of ``block_b``, and their outputs dropped;
  * closures come back masked to ``n_attrs`` bits;
  * supports count only real rows (``supports -= pad rows``).

``use_kernel=False`` runs the plain oracle (``ref.closure_ref``) instead
of K1 — the ``backend="torch"`` path.  There is no width limit that
leaves K1 quietly: K1 takes any width up to its ``MAX_W`` and raises
beyond it.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.device import ALL_ONES, device_bits
from repro_torch.kernels import closure as kclosure
from repro_torch.kernels import ref


def attr_mask_tensor(n_attrs: int, W: int, device) -> torch.Tensor:
    """``[W]`` int32 mask with exactly the first ``n_attrs`` bits set."""
    return device_bits(bitset.attr_mask(n_attrs, W), device)


def _pad_rows(x: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    pad = -x.shape[0] % multiple
    if pad:
        fill = torch.full((pad, x.shape[1]), ALL_ONES, dtype=x.dtype, device=x.device)
        x = torch.cat([x, fill])
    return x, pad


def batched_closure(
    rows: torch.Tensor,
    cands: torch.Tensor,
    n_attrs: int,
    *,
    n_valid_rows: int,
    block_b: int = 8,
    block_n: int = 256,
    use_kernel: bool = True,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched closure with clean semantics.  rows [N,W], cands [B,W].

    ``mask`` is the ``[W]`` attribute mask when the caller already holds
    it on the device; it is built from ``n_attrs`` otherwise.
    """
    N, W = rows.shape
    B = cands.shape[0]
    if mask is None:
        mask = attr_mask_tensor(n_attrs, W, rows.device)
    if not use_kernel:
        closures, supports = ref.closure_ref(rows, cands)
        return closures & mask, supports - (N - n_valid_rows)
    rows, n_row_pad = _pad_rows(rows, block_n)
    cands, _ = _pad_rows(cands, block_b)
    closures, supports = kclosure.closure(rows, cands)
    # All-ones padding rows (pre-existing + added here) match every candidate.
    n_pad_rows = (N - n_valid_rows) + n_row_pad
    return closures[:B] & mask, supports[:B] - n_pad_rows


def bucket_size(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity ≥ n — the candidate chunk shapes the
    drivers pad to (the frontier size changes every iteration)."""
    size = minimum
    while size < n:
        size <<= 1
    return size
