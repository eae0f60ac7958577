"""K1: batched bitset closure — the paper's ⊕ hot-spot.

For candidates ``C [B, W]`` against context rows ``R [N, W]`` (int32 views
of uint32 bitset words) it computes, per candidate ``b``,

    match[n]   = all_w((R[n, w] & C[b, w]) == C[b, w])
    closure[b] = AND of the matching rows        (identity 0xFFFFFFFF)
    support[b] = number of matching rows

raw: not masked to the real attributes, not corrected for all-ones padding
rows (``ops.batched_closure`` does both).  :func:`closure` launches the
CUDA kernel in ``csrc/closure.cu`` for CUDA tensors and runs
:func:`closure_plain` for CPU tensors; any shape ``N >= 0``, ``B >= 0``
and ``1 <= W <= MAX_W`` is taken as it is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import ALL_ONES
from repro_torch.kernels import _build

GROUP = 8  # candidates per CTA (CLOSURE_GROUP in csrc/closure_common.cuh)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on the H100
# Widest word count whose candidates + accumulators fit one block's
# shared memory (closure_smem_bytes in csrc/closure_common.cuh).
MAX_W = (SMEM_LIMIT // 4 - 2 * GROUP) // (2 * GROUP)
# Bound on the [b, N, W] intermediate of the plain version, in elements.
PLAIN_CHUNK_ELEMS = 1 << 25


def and_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-AND reduction along ``dim`` (halving tree; any length).

    An empty axis reduces to the identity (all ones)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n == 0:
        return torch.full(x.shape[1:], ALL_ONES, dtype=x.dtype, device=x.device)
    while n > 1:
        half = n // 2
        folded = x[:half] & x[half : 2 * half]
        x = torch.cat([folded, x[2 * half :]]) if n % 2 else folded
        n = x.shape[0]
    return x[0]


def closure_plain(
    rows: torch.Tensor, cands: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K1: raw closures [B, W], supports [B]."""
    B, W = cands.shape
    N = rows.shape[0]
    out_c = torch.empty((B, W), dtype=torch.int32, device=cands.device)
    out_s = torch.empty((B,), dtype=torch.int32, device=cands.device)
    step = max(1, PLAIN_CHUNK_ELEMS // max(1, N * W))
    for lo in range(0, B, step):
        c = cands[lo : lo + step]
        match = ((rows[None, :, :] & c[:, None, :]) == c[:, None, :]).all(-1)
        sel = torch.where(match[:, :, None], rows[None, :, :], ALL_ONES)
        out_c[lo : lo + step] = and_reduce(sel, dim=1)
        out_s[lo : lo + step] = match.sum(-1, dtype=torch.int32)
    return out_c, out_s


def check_bitsets(name: str, t: torch.Tensor, shape: tuple | None = None):
    """Raise unless ``t`` is a contiguous int32 bitset block of ``shape``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 bitset words, got {t.dtype}")
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D [rows, W], got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_closure_operands(rows: torch.Tensor, cands: torch.Tensor) -> None:
    """The checks K1 and K2 share: types, shapes, width, device."""
    check_bitsets("rows", rows)
    check_bitsets("cands", cands)
    W = rows.shape[1]
    if cands.shape[1] != W:
        raise ValueError(f"word-width mismatch: rows W={W}, cands W={cands.shape[1]}")
    if W < 1:
        raise ValueError("W must be >= 1")
    if rows.device != cands.device:
        raise ValueError(f"rows on {rows.device}, cands on {cands.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    if rows.device.type == "cuda" and W > MAX_W:
        raise ValueError(
            f"W={W} exceeds the kernel's shared-memory limit MAX_W={MAX_W}"
        )
    if max(rows.shape[0], cands.shape[0]) * W >= 2**31:
        raise ValueError("operands exceed the kernel's 32-bit index range")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("closure")
    lib.closure_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p
    ]
    lib.closure_launch.restype = ctypes.c_int
    return lib


def closure(
    rows: torch.Tensor, cands: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: raw closures ``[B, W]`` and supports ``[B]`` (int32).

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`closure_plain`.  ``closure.launches`` counts kernel launches.
    """
    check_closure_operands(rows, cands)
    if rows.device.type == "cpu":
        return closure_plain(rows, cands)
    N, W = rows.shape
    B = cands.shape[0]
    out_c = torch.empty((B, W), dtype=torch.int32, device=rows.device)
    out_s = torch.empty((B,), dtype=torch.int32, device=rows.device)
    if B == 0:
        return out_c, out_s
    with torch.cuda.device(rows.device):
        rc = _lib().closure_launch(
            rows.data_ptr(), cands.data_ptr(), out_c.data_ptr(),
            out_s.data_ptr(), N, B, W,
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"closure kernel launch failed: CUDA error {rc}")
    closure.launches += 1
    return out_c, out_s


closure.launches = 0
