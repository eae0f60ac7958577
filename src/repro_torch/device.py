"""Device resolution and the numpy ↔ torch bitset boundary.

Bitsets cross numpy boundaries as ``uint32``.  Inside torch they are the
same 32 bits viewed as ``int32``: torch lacks ``~ >> << <`` and ``max`` for
``uint32`` on the CPU.  Every place that orders rows sorts on the unsigned
key ``x ^ INT32_MIN`` so row order matches the reference bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MIN = -(2**31)
ALL_ONES = -1  # 0xFFFFFFFF viewed as int32 — the AND identity


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says so.

    Raises instead of falling back to the CPU when CUDA is missing.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def device_bits(arr: np.ndarray, device) -> torch.Tensor:
    """Packed ``uint32`` words → an ``int32`` tensor on ``device`` (a copy)."""
    host = np.array(arr, dtype=np.uint32, copy=True).view(np.int32)
    return torch.from_numpy(host).to(device)


def host_bits(t: torch.Tensor) -> np.ndarray:
    """An ``int32`` bitset tensor → packed ``uint32`` words (a copy)."""
    return np.array(t.detach().cpu().numpy(), copy=True).view(np.uint32)


def unsigned_key(x: torch.Tensor) -> torch.Tensor:
    """``int32`` words whose signed order is the words' unsigned order."""
    return x ^ INT32_MIN
