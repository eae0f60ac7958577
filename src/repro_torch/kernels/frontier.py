"""The frontier-step kernels: K2, the fused step of one-shard plans, and
its two halves on multi-shard plans, K3 (map) and K4 (filter).

K2 — closure, support and driver filter in one pass (single-object-shard
plans).

Per candidate ``b`` of a chunk it computes

    closure[b] = (AND of matching context rows) & mask
    support[b] = #matching rows − n_pad
    keep[b]    = (b + row_off < n_valid)
                 ∧ [support[b] ≥ min_sup]                  (iceberg)
                 ∧ [((closure[b] ^ parent[b]) & lowrow[b]) == 0]   (cbo)

:func:`fused_step` launches the CUDA kernel in ``csrc/frontier.cu`` for
CUDA tensors and runs :func:`fused_step_plain` for CPU tensors.  The
scalars ``(n_valid, min_sup, n_pad, row_off)`` are plain ints passed at
launch, so no threshold or window forces a rebuild.  ``n_valid`` may also
be a 0-dim int32 tensor on the operands' device: the kernel then reads the
count from the device, which is how an async round chains on the survivor
count of the round before it without a host read.  CbO's ``LOW[gen]``
gather stays with the caller (``lowrow``).  Survivor compaction stays in
torch (:mod:`repro_torch.core.frontier`): it consumes only the keep mask
and the closures.

On k > 1 object shards the filter needs the *global* closure, the AND of
the shards' local closures, so the step splits in two
(:meth:`repro_torch.core.engine.ClosureEngine.spmd_step_fused`):

    K3 :func:`map_closure`  per shard: (AND of matching local rows) & mask
                            and the raw local support — rows [K, N/K, W]
                            give [K, B, W] / [K, B] from one launch
    K4 :func:`filter_step`  the AND over the K partials, the support sum
                            − n_pad and the keep mask above (CbO reading
                            ``LOW[gens]`` itself), in one launch

On a simulated plan K4 takes K3's K partials as they are: on one card the
AND-allreduce is that fold.  A process-group rank runs the collectives
between the two and calls K4 at K = 1.  The mask folds into K3 because AND
distributes over it: masked local closures AND-reduce to the masked global
closure.  No pad correction happens in K3; K4 subtracts ``n_pad`` from the
summed supports once.

K2 and K3 share one closure body in ``csrc/frontier.cu``, which the C
launchers choose by the word width alone: for rows of at most
``TCF_MAX_W`` (10) words the tensor-core body (the closure as two int8
``wgmma`` products over complement bit-planes), for wider rows, up to
``closure.max_w``, the SIMT body K1 uses.  Each wrapper counts its
launches in ``launches`` and, as the launcher reports them, those that
took the tensor body in ``tc_launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.closure import (
    and_reduce,
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


def pack_scalars(n_valid, min_sup=0, n_pad=0, row_off=0) -> tuple:
    """The kernel's scalar operands as plain ints in the int32 range; a
    0-dim int32 tensor ``n_valid`` (the count on the device) is kept as it
    is, never read on the host."""
    ints = (min_sup, n_pad, row_off)
    if not isinstance(n_valid, torch.Tensor):
        ints = (n_valid, *ints)
    elif n_valid.dim() != 0 or n_valid.dtype != torch.int32:
        raise ValueError(f"a tensor n_valid must be a 0-dim int32 tensor, got "
                         f"{n_valid.dtype}{tuple(n_valid.shape)}")
    out = tuple(int(v) for v in ints)
    for v in out:
        if not -(2**31) <= v < 2**31:
            raise ValueError(f"scalar {v} outside the int32 range")
    return out if len(out) == N_SCALARS else (n_valid, *out)


def _count_operand(n_valid, device) -> tuple[int, int | None]:
    """``(n_valid for the int argument, device pointer or None)``: a tensor
    count goes to the kernel by pointer, its int argument unread."""
    if not isinstance(n_valid, torch.Tensor):
        return n_valid, None
    if n_valid.device != device:
        raise ValueError(f"n_valid on {n_valid.device}, operands on {device}")
    return 0, n_valid.data_ptr()


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
    flag = ctypes.POINTER(ctypes.c_int)
    lib.fused_step_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [flag, ctypes.c_void_p]
    )
    lib.fused_step_launch.restype = ctypes.c_int
    lib.map_closure_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [flag, ctypes.c_void_p]
    )
    lib.map_closure_launch.restype = ctypes.c_int
    lib.filter_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    lib.filter_launch.restype = ctypes.c_int
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@functools.cache
def _tc_cands() -> int:
    """The tensor body's candidates per CTA: ``fused_step`` gives it one
    arrival counter for each."""
    return _lib().frontier_tc_cands()


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
    ``scalars`` is :func:`pack_scalars`' tuple, its ``n_valid`` an int or
    a 0-dim int32 tensor on the operands' device.  CbO variants also take
    parent/lowrow [B, W].  ``fused_step.launches`` counts kernel launches;
    ``fused_step.tc_launches`` those that took the tensor-core body, which
    the launcher chooses for rows of at most 10 words (wider rows take the
    SIMT body).
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
    n_valid, nv_ptr = _count_operand(scalars[0], rows.device)
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
    # the tensor body's arrival counters, one per CTA of candidates (used
    # where it splits the row axis; the SIMT body ignores them)
    arrived = torch.empty((-(-B // _tc_cands()),), dtype=torch.int32, device=rows.device)
    tensor_body = ctypes.c_int(0)
    with torch.cuda.device(rows.device):
        rc = _lib().fused_step_launch(
            rows.data_ptr(), cands.data_ptr(), mask.data_ptr(),
            parent.data_ptr() if cbo else None,
            lowrow.data_ptr() if cbo else None,
            out_c.data_ptr(), out_s.data_ptr(), keep.data_ptr(),
            arrived.data_ptr(), nv_ptr, N, B, W, n_valid, *scalars[1:], int(iceberg),
            int(cbo),
            ctypes.byref(tensor_body), torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused step kernel launch failed: CUDA error {rc}")
    fused_step.launches += 1
    fused_step.tc_launches += tensor_body.value
    return out_c, out_s, keep


fused_step.launches = 0
fused_step.tc_launches = 0


# ---------------------------------------------------------------------------
# K3: the map half of a multi-shard round
# ---------------------------------------------------------------------------


def map_closure_plain(rows, cands, mask):
    """The plain PyTorch version of K3: masked local closures and raw local
    supports."""
    closures, supports = closure_plain(rows, cands)
    return closures & mask, supports


def map_closure(
    rows: torch.Tensor, cands: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: masked local closures and raw local supports (int32).

    rows ``[K, N, W]`` (K object shards) or ``[N, W]`` (one shard, a
    process-group rank's slice), cands ``[B, W]``, mask ``[1, W]`` →
    ``[K, B, W]`` / ``[K, B]`` (``[B, W]`` / ``[B]`` for 2-D rows).
    ``map_closure.launches`` counts kernel launches;
    ``map_closure.tc_launches`` those that took the tensor-core body, which
    the launcher chooses for rows of at most 10 words (wider rows take the
    SIMT body).
    """
    check_closure_operands(rows, cands, sharded=True)
    W = rows.shape[-1]
    check_bitsets("mask", mask, (1, W))
    if mask.device != rows.device:
        raise ValueError(f"mask on {mask.device}, rows on {rows.device}")
    if rows.device.type == "cpu":
        return map_closure_plain(rows, cands, mask)
    lead = rows.shape[:-2]
    K = rows.shape[0] if lead else 1
    N = rows.shape[-2]
    B = cands.shape[0]
    out_c = torch.empty((*lead, B, W), dtype=torch.int32, device=rows.device)
    out_s = torch.empty((*lead, B), dtype=torch.int32, device=rows.device)
    if B == 0 or K == 0:
        return out_c, out_s
    tensor_body = ctypes.c_int(0)
    with torch.cuda.device(rows.device):
        rc = _lib().map_closure_launch(
            rows.data_ptr(), cands.data_ptr(), mask.data_ptr(),
            out_c.data_ptr(), out_s.data_ptr(), K, N, B, W, ctypes.byref(tensor_body),
            torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"map closure kernel launch failed: CUDA error {rc}")
    map_closure.launches += 1
    map_closure.tc_launches += tensor_body.value
    return out_c, out_s


map_closure.launches = 0
map_closure.tc_launches = 0


# ---------------------------------------------------------------------------
# K4: the filter half of a multi-shard round
# ---------------------------------------------------------------------------


def filter_step_plain(lc, ls, scalars, *, parent=None, LOW=None, gens=None,
                      iceberg: bool = False, cbo: bool = False):
    """The plain PyTorch version of K4: (closures, corrected supports or
    None, keep)."""
    n_valid, min_sup, n_pad, row_off = scalars
    gc = and_reduce(lc, 0) if lc.dim() == 3 else lc
    sup = None
    if ls is not None:
        sup = (ls.sum(0, dtype=torch.int32) if ls.dim() == 2 else ls) - n_pad
    idx = torch.arange(gc.shape[0], device=gc.device) + row_off
    keep = idx < n_valid
    if iceberg:
        keep = keep & (sup >= min_sup)
    if cbo:
        n_low = LOW.shape[0]
        lowrow = LOW[gens.long().clamp(0, n_low - 1)]
        keep = keep & (gens >= 0) & (gens < n_low)
        keep = keep & (((gc ^ parent) & lowrow) == 0).all(-1)
    return gc, sup, keep


def filter_step(
    lc: torch.Tensor,
    ls: torch.Tensor | None,
    scalars,
    *,
    parent: torch.Tensor | None = None,
    LOW: torch.Tensor | None = None,
    gens: torch.Tensor | None = None,
    iceberg: bool = False,
    cbo: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """K4: global closures [B, W], corrected supports [B] (int32) and keep
    [B] (bool) from K shards' partials.

    lc ``[K, B, W]`` are the shards' masked local closures and ls ``[K,
    B]`` their raw supports, or ``[B, W]`` / ``[B]`` for K = 1 (a
    process-group rank's reduced operands); ``ls=None`` returns no
    supports (iceberg needs them).  The closures are the AND over K; at
    K = 1 they are ``lc`` itself, not a copy.  ``scalars`` is
    :func:`pack_scalars`' tuple (``n_valid`` an int or a 0-dim int32 tensor
    on lc's device); ``n_pad`` comes off the summed supports.
    CbO variants also take parent ``[B, W]``, ``LOW [n_low, W]`` and gens
    ``[B]`` int32 (the test reads ``LOW[gens[b]]``; a gens entry outside
    ``[0, n_low)`` drops its candidate).  ``filter_step.launches`` counts
    kernel launches.
    """
    check_bitsets("lc", lc, ndims=(2, 3))
    B, W = lc.shape[-2:]
    K = lc.shape[0] if lc.dim() == 3 else 1
    if W < 1:
        raise ValueError("W must be >= 1")
    if K < 1:
        raise ValueError("lc holds no shard")
    if ls is not None:
        if not isinstance(ls, torch.Tensor) or ls.dtype != torch.int32:
            raise TypeError("ls must be an int32 torch.Tensor")
        if tuple(ls.shape) != tuple(lc.shape[:-1]) or not ls.is_contiguous():
            raise ValueError(f"ls must be contiguous of shape {tuple(lc.shape[:-1])}, "
                             f"got {tuple(ls.shape)}")
    elif iceberg:
        raise ValueError("iceberg=True needs the supports ls")
    if len(scalars) != N_SCALARS:
        raise ValueError(f"scalars must be (n_valid, min_sup, n_pad, row_off), got {scalars!r}")
    scalars = pack_scalars(*scalars)
    operands = [] if ls is None else [ls]
    if cbo:
        if parent is None or LOW is None or gens is None:
            raise ValueError("cbo=True needs parent=, LOW= and gens= operands")
        check_bitsets("parent", parent, (B, W))
        check_bitsets("LOW", LOW)
        if LOW.shape[1] != W or LOW.shape[0] < 1:
            raise ValueError(f"LOW must be [n_low >= 1, {W}], got {tuple(LOW.shape)}")
        if not isinstance(gens, torch.Tensor) or gens.dtype != torch.int32:
            raise TypeError("gens must be an int32 torch.Tensor")
        if tuple(gens.shape) != (B,) or not gens.is_contiguous():
            raise ValueError(f"gens must be contiguous of shape ({B},), got {tuple(gens.shape)}")
        operands += [parent, LOW, gens]
    for t in operands:
        if t.device != lc.device:
            raise ValueError(f"operand on {t.device}, lc on {lc.device}")
    if lc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lc.device}")
    if lc.numel() >= 2**31:
        raise ValueError("operands exceed the kernel's 32-bit index range")
    n_valid, nv_ptr = _count_operand(scalars[0], lc.device)
    if lc.device.type == "cpu":
        return filter_step_plain(lc, ls, scalars, parent=parent, LOW=LOW, gens=gens,
                                 iceberg=iceberg, cbo=cbo)
    gc = lc.reshape(B, W) if K == 1 else torch.empty((B, W), dtype=torch.int32,
                                                     device=lc.device)
    out_s = None if ls is None else torch.empty((B,), dtype=torch.int32, device=lc.device)
    keep = torch.empty((B,), dtype=torch.bool, device=lc.device)
    if B == 0:
        return gc, out_s, keep
    cbo_ops = [parent, LOW, gens] if cbo else [None] * 3
    with torch.cuda.device(lc.device):
        rc = _lib().filter_launch(
            lc.data_ptr(), *map(_ptr, [ls, *cbo_ops]), None if K == 1 else gc.data_ptr(),
            _ptr(out_s), keep.data_ptr(), nv_ptr, K, B, W, LOW.shape[0] if cbo else 0,
            n_valid, *scalars[1:],
            int(iceberg), int(cbo), torch.cuda.current_stream(lc.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"filter kernel launch failed: CUDA error {rc}")
    filter_step.launches += 1
    return gc, out_s, keep


filter_step.launches = 0
