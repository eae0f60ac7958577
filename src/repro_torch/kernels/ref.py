"""The plain PyTorch oracle for K1, with the kernel's contract.

Same contract as :func:`repro_torch.kernels.closure.closure` (raw,
un-masked, un-corrected outputs) so the two can be compared bit for bit;
``backend="torch"`` engines run it as their closure map.
"""

from __future__ import annotations

from repro_torch.kernels.closure import closure_plain


closure_ref = closure_plain  # rows [N, W], cands [B, W] → (closures [B, W], supports [B])
