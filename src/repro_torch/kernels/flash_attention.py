"""K7 — flash attention, forward (the prefill and train paths), and K7b, its backward.

``softmax(softcap(q·kᵀ/√hd)) · v`` over the valid keys, with GQA (query
head ``h`` reads KV head ``h // G``, no repeated K/V), causal masking, a
sliding ``window`` and the gemma2 ``logit_cap``.  Two wrappers launch K7
(``csrc/attention.cu``: bfloat16 through wgmma behind a TMA ring, float32
on the FMA pipes):

:func:`flash_attention` — the contract of the reference's Pallas kernel
    (``src/repro/kernels/flash_attention.py:109``): q ``[B, H, S, hd]``,
    k/v ``[B, KV, T, hd]``, S ≠ T allowed when not causal.
:func:`blockwise_attention` — the model layout of the reference's
    ``blockwise_attention`` (``src/repro/models/attention.py:73``): q
    ``[B, S, H, hd]``, k/v ``[B, S, KV, hd]``, at the positions that
    ``attn_full`` and ``attn_prefill`` give it: ``arange(S)``, and ``-1``
    before each row's ``valid_from`` (left pads).  It takes ``valid_from``
    itself, as the kernel does: keys before it are never attended.  With
    ``q_off`` the queries are rows ``[q_off, q_off + S)`` of a longer
    sequence whose ``T`` keys k/v hold (the query rows one rank of the
    partitioner's sequence-sharded attention owns): query row i sits at
    position ``q_off + i`` in the causal and window masks, and the tile
    ranges each launch visits follow it.  ``q_off`` is a run-time launch
    argument (no rebuild), as are S, T and the masks.

Semantics of both: fp32 scores, running max and sum; ``p`` rounded to V's
dtype before ``P·V`` and the running sum taken over the rounded ``p``
(``blockwise_attention``'s rounding, the one the reference's serving path
uses; a no-op in float32); a query row with no valid key — a left-pad
row — is 0 (the reference leaves the mean of V there, which nothing ever
reads: its keys carry ``pos = -1`` in every later layer and in the
cache).  Element types float32 and bfloat16; hd a multiple of 8 up to
256.

For CUDA tensors each wrapper launches the kernel or raises; for CPU
tensors it runs the plain version, :func:`attention_plain` — the
reference's online-softmax scan over key blocks, written in torch.  Each
wrapper counts its kernel launches in a plain ``launches`` attribute.
The launches are PyTorch operators of their own, ``repro_torch::k7_fwd``
and ``repro_torch::k7b_bwd`` (``torch.library.custom_op``): on fake CUDA
tensors (the dry-run's ``FakeTensorMode``) their fake implementations give
the outputs' shapes and dtypes with no build and no launch, and count
nothing; ``torch.utils.flop_counter`` and ``repro_torch.launch.op_analysis``
read their flop formulas — K7 4 · hd, K7b 10 · hd per (query, key) pair of
B · H · S · T, every pair, as the plain version computes them.

K7b, the backward (``csrc/attention.cu``, :func:`attention_backward`;
bfloat16 through two warp-specialised ``wgmma`` passes behind TMA rings,
float32 on the FMA pipes): the gradient of :func:`blockwise_attention`
without pads — dq, dk and dv from q, k, v, the output, the rows'
log-sum-exp (K7's optional ``lse`` output, not written when serving) and
the output's gradient, with K7's rounding of p to V's dtype in dV.  A
train-mode :func:`blockwise_attention` on the card goes through
:class:`_BlockwiseAttentionFn` (K7 forward, K7b backward); its plain
version is autograd through :func:`attention_plain`
(:func:`attention_backward_plain`), which the CPU path takes.  The
reference has no backward kernel: it differentiates its jnp scan.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

NEG_INF = -(2.0**30)
MAX_HD = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mask(q_pos, kv_pos, causal: bool, window):
    """q_pos [..., S, 1], kv_pos [..., 1, T] → bool valid mask (the
    reference's ``_mask``; ``causal=False`` drops the ``kv ≤ q`` term)."""
    valid = kv_pos >= 0
    if causal:
        valid = valid & (kv_pos <= q_pos)
    if window is not None:
        valid = valid & (q_pos - kv_pos < window)
    return valid


def attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True, window=None,
                    logit_cap=None, kv_block: int = 1024):
    """The plain PyTorch version of K7 in the model layout: q [B, S, H, hd],
    k/v [B, T, KV, hd], q_pos [S] or [B, S], kv_pos [T] or [B, T] (a key
    at a position < 0 is never attended).  The reference's scan: blocks of
    ``kv_block`` keys, fp32 scores, running max, sum and accumulator, ``p``
    rounded to V's dtype; rows with no valid key are 0."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, S, KV, G, hd).float()
    q_pos = q_pos.expand(B, S) if q_pos.dim() == 1 else q_pos
    kv_pos = kv_pos.expand(B, T) if kv_pos.dim() == 1 else kv_pos
    m = torch.full((B, S, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, KV, G, hd), dtype=torch.float32, device=q.device)
    seen = torch.zeros((B, S), dtype=torch.bool, device=q.device)
    step = max(1, min(kv_block, T))
    for lo in range(0, T, step):
        kj = k[:, lo : lo + step].float()
        vj = v[:, lo : lo + step]
        s = torch.einsum("bskgh,btkh->bskgt", qg, kj) * scale
        if logit_cap is not None:
            s = logit_cap * torch.tanh(s / logit_cap)
        valid = _mask(q_pos[:, :, None], kv_pos[:, None, lo : lo + step], causal, window)
        vmask = valid[:, :, None, None, :]
        s = torch.where(vmask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vmask, torch.exp(s - m_new[..., None]), 0.0).to(vj.dtype)
        l = l * alpha + p.sum(-1, dtype=torch.float32)
        pv = torch.einsum("bskgt,btkh->bskgh", p.float(), vj.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
        seen |= valid.any(-1)
    out = acc / torch.clamp_min(l[..., None], 1e-37)
    out = torch.where(seen[:, :, None, None, None], out, 0.0)
    return out.reshape(B, S, H, hd).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None, logit_cap=None):
    """The plain version in K7's own layout: q [B, H, S, hd], k/v
    [B, KV, T, hd] → [B, H, S, hd]."""
    S, T = q.shape[2], k.shape[2]
    out = attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        torch.arange(S, device=q.device), torch.arange(T, device=q.device),
        causal=causal, window=window, logit_cap=logit_cap,
    )
    return out.transpose(1, 2).contiguous()


def _check(q, k, v, window, logit_cap, heads_axis: int) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(x.shape)}")
        if x.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; q is {q.dtype} on {q.device}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    hd = q.shape[3]
    if k.shape != v.shape or k.shape[3] != hd or k.shape[0] != q.shape[0]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not (8 <= hd <= MAX_HD and hd % 8 == 0):
        raise ValueError(f"head dim {hd}: the kernel takes multiples of 8 up to {MAX_HD}")
    H, KV = q.shape[heads_axis], k.shape[heads_axis]
    if H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window={window} must be >= 1 or None")
    if logit_cap is not None and not float(logit_cap) > 0:
        raise ValueError(f"logit_cap={logit_cap} must be > 0 or None")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    )
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_backward_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 6
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.flash_attention_backward_launch.restype = ctypes.c_int
    return lib


def _aligned(*xs: torch.Tensor):
    """The bf16 body reads q, k and v through TMA, which takes a 16-byte
    aligned base and strides in multiples of 16 bytes (8 elements).  A
    tensor that is not so is copied into a fresh contiguous one, which
    is; the kernel raises on anything else."""
    return tuple(
        x if x.dtype != torch.bfloat16 or (x.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for st in x.stride()[:3])) else
        x.clone(memory_format=torch.contiguous_format)
        for x in xs)


def _launch(q, k, v, out, valid_from, *, B, H, KV, S, T, q_st, kv_st, v_st, o_st,
            causal, window, logit_cap, lse=None, q_off: int = 0) -> None:
    hd = q.shape[3]
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if valid_from is None else valid_from.data_ptr(),
            DTYPES[q.dtype], B, H, KV, S, T, hd, *q_st, *kv_st, *v_st, *o_st,
            int(causal), -1 if window is None else int(window), int(q_off),
            0.0 if logit_cap is None else float(logit_cap), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {rc}")


def flash_attention(q, k, v, *, causal: bool = True, window=None, logit_cap=None):
    """K7 with the reference kernel's contract: q [B, H, S, hd], k/v
    [B, KV, T, hd] (float32 or bfloat16, head dim contiguous) → [B, H, S,
    hd].  Raises unless ``H % KV == 0``.  ``flash_attention.launches``
    counts kernel launches."""
    _check(q, k, v, window, logit_cap, heads_axis=1)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap)
    return torch.ops.repro_torch.k7_fwd(q, k, v, None, window, logit_cap, 0, causal, True,
                                        False)[0]


flash_attention.launches = 0


def positions_of(valid_from, B: int, S: int, device=None) -> torch.Tensor:
    """The positions [B, S] of self-attention from ``valid_from`` [B] (or
    None: all 0): ``arange(S)``, and ``-1`` before each row's first real
    token — ``attn_prefill``'s ``pos``."""
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    if valid_from is None:
        return pos
    return torch.where(pos >= valid_from.to(pos.device)[:, None], pos, -1)


def blockwise_attention(q, k, v, *, window, logit_cap, valid_from=None, q_off: int = 0):
    """K7 in the model layout: q [B, S, H, hd], k/v [B, T, KV, hd] →
    [B, S, H, hd], causal self-attention over the T positions
    ``arange(T)`` for the query rows ``[q_off, q_off + S)`` of them (``q_off
    + S <= T``; T = S for a whole sequence); in row b the keys before
    ``valid_from[b]`` (an integer tensor [B], on q's device; None: all 0)
    are never attended and the query rows before it are 0 — the
    reference's ``blockwise_attention`` at the positions
    :func:`positions_of` gives, its queries shifted by ``q_off``.
    ``blockwise_attention.launches`` counts kernel launches.

    Under autograd (grad enabled and q, k or v requiring grad) the result
    has a gradient: on the card through :class:`_BlockwiseAttentionFn` (K7
    forward with its log-sum-exp, K7b backward), on the CPU through the
    plain version.  Training has no left pads, so ``valid_from`` with
    grad is refused (``ValueError``)."""
    _check(q, k, v, window, logit_cap, heads_axis=2)
    B, S, H, _ = q.shape
    KV, T = k.shape[2], k.shape[1]
    q_off = int(q_off)
    if q_off < 0 or q_off + S > T:
        raise ValueError(f"blockwise_attention is self-attention: {T} keys for {S} queries "
                         f"at offset {q_off}")
    if valid_from is not None and (
            not isinstance(valid_from, torch.Tensor) or tuple(valid_from.shape) != (B,)
            or valid_from.dtype.is_floating_point or valid_from.device != q.device):
        raise ValueError(f"valid_from must be an integer tensor [{B}] on {q.device}")
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    if grad and valid_from is not None:
        raise ValueError("blockwise_attention takes no valid_from under autograd "
                         "(training has no left pads)")
    if q.device.type == "cpu":
        pos = positions_of(valid_from, B, T)
        return attention_plain(q, k, v, pos[:, q_off: q_off + S], pos, window=window,
                               logit_cap=logit_cap)
    if grad:
        return _BlockwiseAttentionFn.apply(q, k, v, window, logit_cap, q_off)
    return _blockwise_forward(q, k, v, window, logit_cap, valid_from, q_off=q_off)[0]


def _blockwise_forward(q, k, v, window, logit_cap, valid_from=None, lse: bool = False,
                       q_off: int = 0):
    """K7 on CUDA tensors in the model layout → (out, lse [B, H, S] float32
    when ``lse``, else None)."""
    if valid_from is not None:
        valid_from = valid_from.to(torch.int32).contiguous()
    out, lse_out = torch.ops.repro_torch.k7_fwd(q, k, v, valid_from, window, logit_cap,
                                                int(q_off), True, False, lse)
    return out, (lse_out if lse else None)


def _k7_launch(q, k, v, valid_from, window, logit_cap, q_off, causal, heads_major, want_lse):
    """One K7 launch; ``heads_major``: q [B, H, S, hd] and k/v [B, KV, T,
    hd] (``flash_attention``'s layout), else the model layout.  Counts the
    launch on its wrapper."""
    if heads_major:
        B, H, S, _ = q.shape
        KV, T = k.shape[1], k.shape[2]
        dims = (1, 2)  # (heads, positions)
    else:
        B, S, H, _ = q.shape
        KV, T = k.shape[2], k.shape[1]
        dims = (2, 1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse_out = torch.empty((B, H, S) if want_lse else (0,), dtype=torch.float32, device=q.device)
    if S == 0 or B == 0:
        return out, lse_out

    def st(x):
        return (x.stride(0), x.stride(dims[0]), x.stride(dims[1]))

    q, k, v = _aligned(q, k, v)
    _launch(q, k, v, out, valid_from, B=B, H=H, KV=KV, S=S, T=T, q_st=st(q), kv_st=st(k),
            v_st=st(v), o_st=st(out), causal=causal, window=window, logit_cap=logit_cap,
            lse=lse_out if want_lse else None, q_off=q_off)
    if heads_major:
        flash_attention.launches += 1
    else:
        blockwise_attention.launches += 1
    return out, lse_out


_K7_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor? valid_from, int? window, "
              "float? logit_cap, int q_off, bool causal, bool heads_major, bool want_lse) "
              "-> (Tensor, Tensor)")
_K7B_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
               "int? window, float? logit_cap, int q_off) -> (Tensor, Tensor, Tensor)")

# K7 and K7b as operators of their own: a fake tensor (the dry-run's) gets
# their outputs' shapes from the fake implementations with no launch and
# no build, a dispatch mode sees one op per launch, and the flop counter
# reads their formulas.
_k7_op = torch.library.custom_op("repro_torch::k7_fwd", _k7_launch, mutates_args=(),
                                 device_types="cuda", schema=_K7_SCHEMA)


@_k7_op.register_fake
def _k7_fake(q, k, v, valid_from, window, logit_cap, q_off, causal, heads_major, want_lse):
    B, H, S = (q.shape[0], q.shape[1], q.shape[2]) if heads_major else \
        (q.shape[0], q.shape[2], q.shape[1])
    return (q.new_empty(q.shape),
            q.new_empty((B, H, S) if want_lse else (0,), dtype=torch.float32))


def _pairs(q_shape, k_shape, heads_major: bool) -> int:
    """B · H · S · T, every (query, key) pair of a launch."""
    if heads_major:
        return q_shape[0] * q_shape[1] * q_shape[2] * k_shape[2]
    return q_shape[0] * q_shape[2] * q_shape[1] * k_shape[1]


@register_flop_formula(torch.ops.repro_torch.k7_fwd)
def _k7_flops(q_shape, k_shape, v_shape, valid_from, window, logit_cap, q_off, causal,
              heads_major, want_lse, out_shape=None, **kwargs) -> int:
    """4 · hd a (query, key) pair: S = q·kᵀ and P·V over every pair, as the
    plain version and the reference's blockwise products compute them."""
    return 4 * q_shape[3] * _pairs(q_shape, k_shape, heads_major)


blockwise_attention.launches = 0


class _BlockwiseAttentionFn(torch.autograd.Function):
    """K7 with a gradient: the forward is K7 (one launch, with the rows'
    log-sum-exp kept for the backward), the backward K7b
    (:func:`attention_backward`).  Saves q, k, v, the output and the
    log-sum-exp; nothing of size S² is kept."""

    @staticmethod
    def forward(ctx, q, k, v, window, logit_cap, q_off=0):
        out, lse = _blockwise_forward(q, k, v, window, logit_cap, lse=True, q_off=q_off)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.logit_cap, ctx.q_off = window, logit_cap, q_off
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, dout, window=ctx.window,
                                        logit_cap=ctx.logit_cap, q_off=ctx.q_off)
        return dq, dk, dv, None, None, None


def attention_backward_plain(q, k, v, dout, *, window=None, logit_cap=None, q_pos=None):
    """The plain version of K7b: autograd through :func:`attention_plain`
    (causal self-attention over the keys at ``arange(T)``, the queries at
    ``q_pos`` [S] or [B, S], default ``arange(S)``) → (dq, dk, dv) in q's,
    k's and v's dtypes."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
        if q_pos is None:
            q_pos = torch.arange(q.shape[1], device=q.device)
        out = attention_plain(q, k, v, q_pos, torch.arange(k.shape[1], device=q.device),
                              window=window, logit_cap=logit_cap)
        return torch.autograd.grad(out, (q, k, v), dout)


def attention_backward(q, k, v, out, lse, dout, *, window=None, logit_cap=None,
                       events=None, q_off: int = 0):
    """K7b: the gradient of :func:`blockwise_attention` without pads, in the
    model layout — q, dout [B, S, H, hd], k/v [B, T, KV, hd] (T = S, or the
    keys of which q holds rows ``[q_off, q_off + S)``), the forward's
    ``out`` and its log-sum-exp ``lse`` [B, H, S] float32 → (dq, dk, dv).
    For CUDA tensors it launches the kernel or raises: three kernels on the
    current stream (D = rowsum(dout ∘ out), the dK/dV pass, the dQ pass;
    deterministic: no atomics).  ``events``, four ``torch.cuda.Event``
    objects or None, are recorded before the first launch and after each
    of the three, so that a caller can time the passes apart.  For CPU
    tensors it runs the plain version (``out``, ``lse`` and ``events``
    unused).  ``attention_backward.launches`` counts kernel launches."""
    _check(q, k, v, window, logit_cap, heads_axis=2)
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} and out {tuple(out.shape)} must be "
                         f"q's shape {tuple(q.shape)}")
    B, S, H, hd = q.shape
    KV, T = k.shape[2], k.shape[1]
    q_off = int(q_off)
    if q_off < 0 or q_off + S > T:
        raise ValueError(f"{T} keys for {S} queries at offset {q_off}")
    if q.device.type == "cpu":
        return attention_backward_plain(
            q, k, v, dout, window=window, logit_cap=logit_cap,
            q_pos=torch.arange(q_off, q_off + S, device=q.device))
    if lse is None or tuple(lse.shape) != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B}, {H}, {S}]")
    if events is not None:
        return _k7b_launch(q, k, v, out, lse, dout, window, logit_cap, q_off, events)
    return torch.ops.repro_torch.k7b_bwd(q, k, v, out, lse, dout, window, logit_cap, q_off)


def _k7b_launch(q, k, v, out, lse, dout, window, logit_cap, q_off, events=None):
    """K7b's three passes on CUDA tensors (see :func:`attention_backward`)."""
    B, S, H, hd = q.shape
    KV, T = k.shape[2], k.shape[1]
    q, k, v, out, dout = _aligned(*(x.contiguous() for x in (q, k, v, out, dout.to(q.dtype))))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if S == 0 or B == 0:
        return dq, dk, dv
    dsum = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPES[q.dtype], B, H, KV, S, T, hd,
            q.stride(0), q.stride(2), q.stride(1), k.stride(0), k.stride(2), k.stride(1),
            1, -1 if window is None else int(window), q_off,
            0.0 if logit_cap is None else float(logit_cap), 1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        # the D pass, the dK/dV pass and the dQ pass: one call, or one each
        # with an event after it
        parts = (7,) if events is None else (1, 2, 4)
        if events is not None:
            events[0].record(stream)
        for i, part in enumerate(parts):
            rc = _lib().flash_attention_backward_launch(*args, part, stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(
                    f"flash attention backward kernel launch failed: CUDA error {rc}")
            if events is not None:
                events[i + 1].record(stream)
    attention_backward.launches += 1
    return dq, dk, dv


_k7b_op = torch.library.custom_op("repro_torch::k7b_bwd", _k7b_launch, mutates_args=(),
                                  device_types="cuda", schema=_K7B_SCHEMA)


@_k7b_op.register_fake
def _k7b_fake(q, k, v, out, lse, dout, window, logit_cap, q_off):
    return (q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape))


@register_flop_formula(torch.ops.repro_torch.k7b_bwd)
def _k7b_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape, dout_shape, window,
               logit_cap, q_off, out_shape=None, **kwargs) -> int:
    """10 · hd a (query, key) pair: its passes recompute S (2 hd), then dP
    (2 hd), dV, dK and dQ (2 hd each)."""
    return 10 * q_shape[3] * _pairs(q_shape, k_shape, False)


attention_backward.launches = 0
