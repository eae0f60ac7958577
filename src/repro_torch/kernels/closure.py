"""K1: batched bitset closure — the paper's ⊕ hot-spot.

For candidates ``C [B, W]`` against context rows ``R [N, W]`` (int32 views
of uint32 bitset words) it computes, per candidate ``b``,

    match[n]   = all_w((R[n, w] & C[b, w]) == C[b, w])
    closure[b] = AND of the matching rows        (identity 0xFFFFFFFF)
    support[b] = number of matching rows

raw: not masked to the real attributes, not corrected for all-ones padding
rows (``ops.batched_closure`` does both).  :func:`closure` launches the
CUDA kernel for CUDA tensors and runs :func:`closure_plain` for CPU
tensors; any shape ``N >= 0``, ``B >= 0`` and ``1 <= W <= max_w`` is
taken as it is.  Rows ``[K, N, W]`` hold K object shards (a simulated
plan's context): each shard's closures and supports come back
separately, ``[K, B, W]`` and ``[K, B]``, from one launch.

The kernel is K3's closure body in ``csrc/frontier.cu`` without its mask
(``closure_launch``), chosen by the word width alone: for rows of at most
10 words (``TCF_MAX_W``) the tensor-core body (two int8 ``wgmma``
products over complement bit-planes, the row axis split across CTAs
where the candidate tiles leave SMs idle), for wider rows the SIMT body.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import ALL_ONES
from repro_torch.kernels import _build

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
    """The plain PyTorch version of K1: raw closures [B, W], supports [B]
    (``[K, B, W]`` and ``[K, B]`` for rows ``[K, N, W]``)."""
    if rows.dim() == 3:
        parts = [closure_plain(r, cands) for r in rows]
        return (torch.stack([c for c, _ in parts]), torch.stack([s for _, s in parts]))
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


def check_bitsets(name: str, t: torch.Tensor, shape: tuple | None = None,
                  *, ndims: tuple[int, ...] = (2,)):
    """Raise unless ``t`` is a contiguous int32 bitset block of ``shape``
    (2-D ``[rows, W]``, or 3-D ``[shards, rows, W]`` where ``ndims``
    allows it)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 bitset words, got {t.dtype}")
    if t.dim() not in ndims:
        raise ValueError(
            f"{name} must be {' or '.join(f'{d}-D' for d in ndims)} "
            f"[..., rows, W], got shape {tuple(t.shape)}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_closure_operands(rows: torch.Tensor, cands: torch.Tensor,
                           *, sharded: bool = False) -> None:
    """The checks K1, K2 and K3 share: types, shapes, width, device.
    ``sharded`` admits rows ``[K, N, W]``."""
    check_bitsets("rows", rows, ndims=(2, 3) if sharded else (2,))
    check_bitsets("cands", cands)
    W = rows.shape[-1]
    if cands.shape[1] != W:
        raise ValueError(f"word-width mismatch: rows W={W}, cands W={cands.shape[1]}")
    if W < 1:
        raise ValueError("W must be >= 1")
    if rows.device != cands.device:
        raise ValueError(f"rows on {rows.device}, cands on {cands.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    if rows.device.type == "cuda" and W > (limit := max_w(rows.device)):
        raise ValueError(f"W={W} exceeds the kernel's shared-memory limit max_w={limit}")
    K = rows.shape[0] if rows.dim() == 3 else 1
    if max(rows.numel(), K * cands.numel()) >= 2**31:
        raise ValueError("operands exceed the kernel's 32-bit index range")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier")
    lib.closure_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p
    ]
    lib.closure_launch.restype = ctypes.c_int
    lib.frontier_simt_max_w.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.frontier_simt_max_w.restype = ctypes.c_int
    return lib


@functools.cache
def max_w(device: torch.device) -> int:
    """The widest rows, in words, the kernels take on ``device``: the SIMT
    body's candidates and accumulators in the shared memory one block may
    use (``frontier_simt_max_w`` in ``csrc/frontier.cu``; 3631 words on the
    H100).  Needs the built library (a CUDA machine)."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        rc = _lib().frontier_simt_max_w(ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"frontier_simt_max_w failed: CUDA error {rc}")
    return out.value


def closure(
    rows: torch.Tensor, cands: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: raw closures ``[B, W]`` and supports ``[B]`` (int32); for rows
    ``[K, N, W]`` (K object shards) ``[K, B, W]`` and ``[K, B]``, from one
    launch.

    CUDA tensors launch the kernel on the current stream; CPU tensors run
    :func:`closure_plain`.  ``closure.launches`` counts kernel launches;
    ``closure.tc_launches`` those that took the tensor-core body, which the
    launcher chooses for rows of at most 10 words (wider rows take the SIMT
    body).
    """
    check_closure_operands(rows, cands, sharded=True)
    if rows.device.type == "cpu":
        return closure_plain(rows, cands)
    lead = rows.shape[:-2]
    K = rows.shape[0] if lead else 1
    N, W = rows.shape[-2:]
    B = cands.shape[0]
    out_c = torch.empty((*lead, B, W), dtype=torch.int32, device=rows.device)
    out_s = torch.empty((*lead, B), dtype=torch.int32, device=rows.device)
    if B == 0 or K == 0:
        return out_c, out_s
    tensor_body = ctypes.c_int(0)
    with torch.cuda.device(rows.device):
        rc = _lib().closure_launch(
            rows.data_ptr(), cands.data_ptr(), out_c.data_ptr(),
            out_s.data_ptr(), K, N, B, W, ctypes.byref(tensor_body),
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"closure kernel launch failed: CUDA error {rc}")
    closure.launches += 1
    closure.tc_launches += tensor_body.value
    return out_c, out_s


closure.launches = 0
closure.tc_launches = 0
