"""Public wrapper around K1 with the correction discipline.

    closures, supports = batched_closure(rows, cands, n_attrs,
                                         n_valid_rows=N_real)

  * rows may carry pre-existing all-ones padding (``n_valid_rows`` real);
    K1 takes any ``N >= 0`` and ``B >= 0`` as they are, so nothing is
    padded here;
  * closures come back masked to ``n_attrs`` bits;
  * supports count only real rows (``supports -= pad rows``).

``use_kernel=False`` runs the plain oracle (``ref.closure_ref``) instead
of K1 — the ``backend="torch"`` path.  There is no width limit that
leaves K1 quietly: K1 takes any width up to its ``max_w`` and raises
beyond it.  Rows ``[K, N, W]`` are K object shards, closed shard by shard
(``[K, B, W]`` / ``[K, B]``) in one K1 launch; ``n_valid_rows`` then
counts real rows per shard.

:func:`closure_matmul` is the ``backend="matmul"`` map: the closure as two
matrix products over complement bit-planes, in plain ``torch.matmul``
(the reference computes it outside any Pallas kernel, too).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.device import device_bits, pack_lanes, unpack_lanes
from repro_torch.kernels import closure as kclosure
from repro_torch.kernels import ref


def attr_mask_tensor(n_attrs: int, W: int, device) -> torch.Tensor:
    """``[W]`` int32 mask with exactly the first ``n_attrs`` bits set."""
    return device_bits(bitset.attr_mask(n_attrs, W), device)


def batched_closure(
    rows: torch.Tensor,
    cands: torch.Tensor,
    n_attrs: int,
    *,
    n_valid_rows: int,
    use_kernel: bool = True,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched closure with clean semantics.  rows [N,W] or [K,N,W],
    cands [B,W].

    ``mask`` is the ``[W]`` attribute mask when the caller already holds
    it on the device; it is built from ``n_attrs`` otherwise.
    """
    N, W = rows.shape[-2:]
    if mask is None:
        mask = attr_mask_tensor(n_attrs, W, rows.device)
    run = kclosure.closure if use_kernel else ref.closure_ref
    closures, supports = run(rows, cands)
    # the caller's all-ones padding rows match every candidate
    return closures & mask, supports - (N - n_valid_rows)


def closure_matmul(
    rows: torch.Tensor,
    cands: torch.Tensor,
    n_attrs: int,
    *,
    n_valid_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closure as two matrix products over complement bit-planes.

    Let ``R̄ ∈ {0,1}^{N×m}`` be the complement of the unpacked context and
    ``C ∈ {0,1}^{B×m}`` the unpacked candidates.  Then

        miss   = C · R̄ᵀ          (miss[b,n] = #candidate attrs absent in row n)
        match  = (miss == 0)
        absent = match · R̄        (absent[b,m] = #matching rows missing attr m)
        Y''    = (absent == 0)

    {0,1} inputs in bf16 (the card's matrix products accumulate it in
    fp32).  Only the zero test of each
    product is read, and a sum of non-negative integers is zero exactly
    when every term is, so the test is exact whatever the accumulation
    precision; supports are the integer match counts.  All-ones padding
    rows have an empty complement, so they match every candidate and add
    no absences (supports corrected by ``N − n_valid_rows``).  Closures
    come back masked to ``n_attrs`` bits.  Rows ``[K, N, W]`` are K object
    shards, closed shard by shard (a batched product).
    """
    N, W = rows.shape[-2:]
    rows_c = (1 - unpack_lanes(rows, n_attrs)).to(torch.bfloat16)  # [.., N, m]
    cand_b = unpack_lanes(cands, n_attrs).to(torch.bfloat16)  # [B, m]
    match = torch.matmul(cand_b, rows_c.transpose(-1, -2)) == 0  # [.., B, N]
    closed = torch.matmul(match.to(torch.bfloat16), rows_c) == 0  # [.., B, m]
    closures = pack_lanes(closed.to(torch.int32), W)
    supports = match.sum(-1, dtype=torch.int32) - (N - n_valid_rows)
    return closures, supports


def bucket_size(n: int, minimum: int = 8) -> int:
    """Next power-of-two capacity ≥ n — the candidate chunk shapes the
    drivers pad to (the frontier size changes every iteration)."""
    size = minimum
    while size < n:
        size <<= 1
    return size
