"""Device resolution and the numpy ↔ torch bitset boundary.

Bitsets cross numpy boundaries as ``uint32``.  Inside torch they are the
same 32 bits viewed as ``int32``: torch lacks ``~ >> << <`` and ``max`` for
``uint32`` on the CPU.  Every place that orders rows sorts on the unsigned
key ``x ^ INT32_MIN`` so row order matches the reference bit for bit.
``unpack_lanes`` / ``pack_lanes`` convert words to 0/1 attribute lanes and
back (the ``pmin`` schedule and the ``matmul`` backend work on lanes).
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


def unpack_lanes(x: torch.Tensor, m: int) -> torch.Tensor:
    """int32 words ``[..., W]`` → the first ``m`` 0/1 bit lanes ``[..., m]``."""
    shifts = torch.arange(32, dtype=torch.int32, device=x.device)
    bits = (x[..., None] >> shifts) & 1  # arithmetic shift: bit 31 → (-1 or 0) & 1
    return bits.reshape(*x.shape[:-1], x.shape[-1] * 32)[..., :m]


def pack_lanes(bits: torch.Tensor, W: int) -> torch.Tensor:
    """0/1 lanes ``[..., m]`` (m ≤ 32·W) → int32 words ``[..., W]``."""
    pad = W * 32 - bits.shape[-1]
    if pad:
        bits = torch.cat([bits, bits.new_zeros((*bits.shape[:-1], pad))], dim=-1)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(*bits.shape[:-1], W, 32).long() << shifts).sum(-1)
    # the low 32 bits as a signed int32, with no int32 overflow on the way
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
