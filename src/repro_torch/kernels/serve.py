"""The serving kernels: K5 (contains top-k) and K6 (rules top-k).

Both run the same shape of computation over a table every query reads:
a bitwise subset test per (query, table row) pair, a validity/threshold
mask, then a top-k selection.

K5 :func:`contains_topk` — ``QueryEngine.topk_batch``'s post stage: for
    each closed query ``gc [S, W]``, the concepts among ``idx <
    n_concepts`` whose intent ⊇ the query, top ``k`` by support
    (descending, ties to the lower concept index); a concept of support 0
    is a hit.  Returns ``(ids [S, k], supports [S, k])``, ``(-1, -1)``
    after the last hit.
K6 :func:`rules_topk` — ``QueryEngine.rules_batch``: the rules among
    ``idx < n_rules`` whose premise ⊆ the query and whose confidence ≥
    ``min_conf`` (compared in float32, ``min_conf`` rounded to float32
    first) fire; returns the top ``k`` firing rules by ``metric``
    (descending, ties to the lowest rule id, then position), their
    metric, ``(-1, -1.0)`` after the last hit, and the OR of the added
    attributes of *every* firing rule ``[S, W]``.

Both launch the CUDA kernels of ``csrc/serve.cu`` for CUDA tensors and run
their plain PyTorch versions (:func:`contains_topk_plain`,
:func:`rules_topk_plain`: the reference engine's jnp steps, written in
torch) for CPU tensors; a build or launch error propagates.  Each wrapper
counts its launches in a plain ``launches`` attribute.  Both split the
live table across a second grid axis (:func:`topk_plan`, stated once in
``csrc/serve.cu``), and the last CTA of each query block merges the
slices' top-k lists.

**Bound change against the reference.**  The reference's
``supports_serve`` (``src/repro/kernels/serve.py:53``) sends a table of
more than ``MAX_TABLE_CELLS = 2**22`` cells, or a slot count that is not a
multiple of 8, back to the jnp step: both limits come from the TPU's VMEM
and block shape.  These kernels stream the table from device memory, so
the port has no such gate: ``backend="kernel"`` sends every shape to
them, and they take any S, C or R and W.  They answer at any ``k ≥ 1``,
as the reference does: one launch selects at most :data:`PASS_K`
winners, so a call with ``k > PASS_K`` launches ``ceil(k / PASS_K)``
passes, each keeping only the entries after the previous pass's last
winner (both orders are total; K6 ORs its union in the first pass only),
and counts each launch.  ``k < 1`` raises ``ValueError``.  Metrics are
finite and ≥ 0, as confidences and lifts are; a NaN or negative metric
is outside the contract.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.closure import check_bitsets

PASS_K = 64  # SERVE_MAX_K in csrc/serve.cu: the winners one launch selects
INT32_MAX = 2**31 - 1
# Bound on the [b, rows] intermediates of the plain versions, in elements.
PLAIN_CHUNK_ELEMS = 1 << 26


def _check_k(k: int) -> int:
    k = int(k)
    if k < 1:
        raise ValueError(f"k={k}: the top k needs k >= 1")
    return k


def _passes(k: int):
    """``(k0, kp)`` of each launch: columns ``[k0, k0 + kp)`` of the output."""
    return [(k0, min(PASS_K, k - k0)) for k0 in range(0, k, PASS_K)]


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_vector(name: str, t: torch.Tensor, n: int, dtype: torch.dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != (n,) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous of shape ({n},), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _check_table(queries: torch.Tensor, tables: dict, vectors: dict) -> None:
    check_bitsets("queries", queries)
    W = queries.shape[1]
    if W < 1:
        raise ValueError("W must be >= 1")
    n = None
    for name, t in tables.items():
        check_bitsets(name, t)
        if t.shape[1] != W:
            raise ValueError(f"word-width mismatch: queries W={W}, {name} W={t.shape[1]}")
        if t.device != queries.device:
            raise ValueError(f"{name} on {t.device}, queries on {queries.device}")
        n = t.shape[0] if n is None else n
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
    for name, (t, dtype) in vectors.items():
        _check_vector(name, t, n, dtype, queries.device)
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")
    if max(queries.numel(), n * W) >= 2**31:
        raise ValueError("operands exceed the kernels' 32-bit index range")


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction along ``dim`` (halving tree; an empty axis
    reduces to 0)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while n > 1:
        half = n // 2
        folded = x[:half] | x[half : 2 * half]
        x = torch.cat([folded, x[2 * half :]]) if n % 2 else folded
        n = x.shape[0]
    return x[0]


def _subset_rows(small: torch.Tensor, big: torch.Tensor, valid: torch.Tensor,
                 queries_small: bool) -> torch.Tensor:
    """``[b, rows]``: ``query ⊆ row`` (``queries_small``) or ``row ⊆
    query`` for every pair, and ``valid[row]``; one word at a time, so no
    ``[b, rows, W]`` intermediate is built."""
    out = valid[None, :].expand(small.shape[0] if queries_small else big.shape[0], -1).clone()
    for w in range(small.shape[1]):
        if queries_small:  # small = queries [b, W], big = table [R, W]
            out &= (small[:, w : w + 1] & ~big[None, :, w]) == 0
        else:  # small = table [R, W], big = queries [b, W]
            out &= (small[None, :, w] & ~big[:, w : w + 1]) == 0
    return out


def _topk_int(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k argmax passes over int scores ``[b, C]`` (the reference's
    ``_topk_int``): value descending, index ascending on ties; the taken
    cell becomes -2, below every live score ≥ -1."""
    ids, vals = [], []
    for _ in range(k):
        idx = scores.argmax(1)  # the first maximum
        ids.append(idx.to(torch.int32))
        vals.append(scores.gather(1, idx[:, None])[:, 0])
        scores.scatter_(1, idx[:, None], -2)
    idx, vals = torch.stack(ids, 1), torch.stack(vals, 1)
    return torch.where(vals >= 0, idx, -1), vals.clamp_min(-1)


def contains_topk_plain(gc, intents, supports, n_concepts: int, *, k: int):
    """The plain PyTorch version of K5: ``(ids [S, k], supports [S, k])``."""
    S, W = gc.shape
    C = intents.shape[0]
    out_i = torch.full((S, k), -1, dtype=torch.int32, device=gc.device)
    out_v = torch.full((S, k), -1, dtype=torch.int32, device=gc.device)
    if C == 0:
        return out_i, out_v
    valid = torch.arange(C, device=gc.device) < n_concepts
    step = max(1, PLAIN_CHUNK_ELEMS // C)
    for lo in range(0, S, step):
        contains = _subset_rows(gc[lo : lo + step], intents, valid, True)
        scores = torch.where(contains, supports[None, :], -1).to(torch.int32)
        out_i[lo : lo + step], out_v[lo : lo + step] = _topk_int(scores, k)
    return out_i, out_v


def rules_topk_plain(prem, added, conf, metric, rid, n_rules: int, queries,
                     min_conf: float, *, k: int):
    """The plain PyTorch version of K6: ``(ids [S, k], scores [S, k],
    unions [S, W])``."""
    S, W = queries.shape
    R = prem.shape[0]
    out_i = torch.full((S, k), -1, dtype=torch.int32, device=queries.device)
    out_v = torch.full((S, k), -1.0, dtype=torch.float32, device=queries.device)
    out_u = torch.zeros((S, W), dtype=torch.int32, device=queries.device)
    if R == 0:
        return out_i, out_v, out_u
    min_conf = torch.tensor(np.float32(min_conf), device=queries.device)
    live = (torch.arange(R, device=queries.device) < n_rules) & (conf >= min_conf)
    step = max(1, PLAIN_CHUNK_ELEMS // R)
    for lo in range(0, S, step):
        q = queries[lo : lo + step]
        ok = _subset_rows(prem, q, live, False)  # [b, R]
        out_u[lo : lo + step] = torch.stack(
            [or_reduce(torch.where(ok, added[None, :, w], 0), 1) for w in range(W)], 1)
        score = torch.where(ok, metric[None, :], -1.0)
        ids, vals = [], []
        for _ in range(k):
            best = score.max(1).values
            is_best = score == best[:, None]
            sel = torch.where(is_best, rid[None, :], INT32_MAX).min(1).values
            pos = (is_best & (rid[None, :] == sel[:, None])).to(torch.int8).argmax(1)
            ids.append(sel)
            vals.append(best)
            score.scatter_(1, pos[:, None], -2.0)
        vals, idx = torch.stack(vals, 1), torch.stack(ids, 1)
        out_i[lo : lo + step] = torch.where(vals >= 0, idx, -1)
        out_v[lo : lo + step] = vals.clamp_min(-1.0)
    return out_i, out_v, out_u


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("serve")
    lib.contains_topk_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.contains_topk_launch.restype = ctypes.c_int
    lib.rules_topk_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    )
    lib.rules_topk_launch.restype = ctypes.c_int
    flag = ctypes.POINTER(ctypes.c_int)
    lib.topk_plan.argtypes = [ctypes.c_int] * 3 + [flag] * 3
    lib.topk_plan.restype = None
    return lib


def topk_plan(S: int, live: int, sms: int) -> tuple[int, int, int]:
    """K5's and K6's split of the live table, from ``topk_plan`` in
    ``csrc/serve.cu``: ``(slice_rows, nslice, blocks)``, slice ``j``
    holding rows ``[j·slice_rows, (j + 1)·slice_rows)`` of ``[0, live)``
    for each of the ``blocks`` query blocks of ``S`` queries on a card of
    ``sms`` SMs.  Needs the built library (a CUDA machine)."""
    out = [ctypes.c_int() for _ in range(3)]
    _lib().topk_plan(S, live, sms, *map(ctypes.byref, out))
    return tuple(o.value for o in out)


def contains_topk(
    gc: torch.Tensor,
    intents: torch.Tensor,
    supports: torch.Tensor,
    n_concepts: int,
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: top-``k`` concepts by support containing each closed query.

    gc [S, W] and intents [C, W] are int32 bitset blocks, supports [C]
    int32, ``n_concepts`` a plain int (rows at or past it are padding).
    Returns ``(ids [S, k], supports [S, k])`` int32, any ``k ≥ 1``
    (one launch per :data:`PASS_K` columns).  One launch splits the live
    intents into the slices of :func:`topk_plan`; each CTA's top ``k`` go
    to scratch allocated here from that plan, and the last CTA of each
    query block merges them.  ``contains_topk.launches`` counts kernel
    launches.
    """
    k = _check_k(k)
    _check_table(gc, {"intents": intents}, {"supports": (supports, torch.int32)})
    n_concepts = int(n_concepts)
    if gc.device.type == "cpu":
        return contains_topk_plain(gc, intents, supports, n_concepts, k=k)
    S, W = gc.shape
    C = intents.shape[0]
    out_i = torch.empty((S, k), dtype=torch.int32, device=gc.device)
    out_v = torch.empty((S, k), dtype=torch.int32, device=gc.device)
    if S == 0:
        return out_i, out_v
    passes = _passes(k)
    dev = gc.device
    live = max(-1, min(n_concepts, C))
    slice_rows, nslice, blocks = topk_plan(S, live, _sm_count(dev))
    # each slice's top k per query (support, index), and each query block's arrivals
    part = torch.empty((S, nslice, passes[0][1], 2), dtype=torch.int32, device=dev)
    arrived = torch.empty(blocks, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0, kp in passes:
            rc = _lib().contains_topk_launch(
                gc.data_ptr(), intents.data_ptr(), supports.data_ptr(),
                out_i.data_ptr(), out_v.data_ptr(), part.data_ptr(), arrived.data_ptr(),
                S, C, W, live, k, k0, kp, slice_rows, nslice, stream,
            )
            if rc != 0:
                raise RuntimeError(f"contains top-k kernel launch failed: CUDA error {rc}")
            contains_topk.launches += 1
    return out_i, out_v


contains_topk.launches = 0


def rules_topk(
    prem: torch.Tensor,
    added: torch.Tensor,
    conf: torch.Tensor,
    metric: torch.Tensor,
    rid: torch.Tensor,
    n_rules: int,
    queries: torch.Tensor,
    min_conf: float,
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: rule lookup — premise ⊆ query, confidence ≥ ``min_conf`` (in
    float32), live (``idx < n_rules``) → top-``k`` by ``metric`` with the
    rule-id tie-break, and the OR of every firing rule's added words.

    prem/added [R, W] int32 bitsets, conf/metric [R] float32, rid [R]
    int32, queries [S, W].  Returns ``(rule ids [S, k] int32, scores
    [S, k] float32, unions [S, W] int32)``, any ``k ≥ 1`` (one launch per
    :data:`PASS_K` columns).  One launch splits the live table into the
    slices of :func:`topk_plan`; each CTA's top ``k`` go to scratch
    allocated here from that plan, and the last CTA of each query block
    merges them.
    ``rules_topk.launches`` counts kernel launches.
    """
    k = _check_k(k)
    _check_table(
        queries, {"prem": prem, "added": added},
        {"conf": (conf, torch.float32), "metric": (metric, torch.float32),
         "rid": (rid, torch.int32)},
    )
    n_rules = int(n_rules)
    min_conf = float(np.float32(min_conf))
    if queries.device.type == "cpu":
        return rules_topk_plain(prem, added, conf, metric, rid, n_rules, queries,
                                min_conf, k=k)
    S, W = queries.shape
    R = prem.shape[0]
    out_i = torch.empty((S, k), dtype=torch.int32, device=queries.device)
    out_v = torch.empty((S, k), dtype=torch.float32, device=queries.device)
    out_u = torch.empty((S, W), dtype=torch.int32, device=queries.device)
    if S == 0:
        return out_i, out_v, out_u
    passes = _passes(k)
    dev = queries.device
    # each query's last winner's table position, from one pass to the next
    cursor = torch.empty(S, dtype=torch.int32, device=dev) if len(passes) > 1 else None
    slice_rows, nslice, blocks = topk_plan(S, min(n_rules, R), _sm_count(dev))
    # each slice's top k per query, and each query block's arrivals
    part = torch.empty((S, nslice, passes[0][1], 4), dtype=torch.int32, device=dev)
    arrived = torch.empty(blocks, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k0, kp in passes:
            rc = _lib().rules_topk_launch(
                prem.data_ptr(), added.data_ptr(), conf.data_ptr(), metric.data_ptr(),
                rid.data_ptr(), queries.data_ptr(),
                out_i.data_ptr(), out_v.data_ptr(), out_u.data_ptr(),
                None if cursor is None else cursor.data_ptr(),
                part.data_ptr(), arrived.data_ptr(),
                S, R, W, max(-1, min(n_rules, R)), min_conf, k, k0, kp, slice_rows, nslice,
                stream,
            )
            if rc != 0:
                raise RuntimeError(f"rules top-k kernel launch failed: CUDA error {rc}")
            rules_topk.launches += 1
    return out_i, out_v, out_u


rules_topk.launches = 0
