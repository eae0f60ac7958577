"""RecurrentGemma / Griffin recurrent blocks: RG-LRU + temporal conv.

The port of the reference's ``repro.models.griffin``.  The recurrent block
runs two branches from the block input:
  * gate branch:       linear(d→w) → GeLU (tanh)
  * recurrence branch: linear(d→w) → causal conv1d(K) → RG-LRU
merged multiplicatively and projected back (w→d).

RG-LRU (Real-Gated Linear Recurrent Unit), in float32 from parameters
cast to float32:
    r_t = σ(x_t W_a + b_a)                     recurrence gate
    i_t = σ(x_t W_x + b_x)                     input gate
    a_t = exp(−c · softplus(Λ) · r_t)          (c = 8)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill evaluates the recurrence as a log-depth scan (the reference's
``lax.associative_scan``): ⌈log₂ L⌉ doubling steps of elementwise torch
ops on the pairs ``(a, b)``, no per-token loop.  Decode keeps the explicit
``[B, w]`` state and the last K−1 pre-conv inputs (``RecCache``).  Left
pads run through the recurrence, as in the reference.  Gate projections
are dense ``[w, w]`` (the reference's simplification of the official
block-diagonal gates).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

_C = 8.0


class RecCache(NamedTuple):
    conv: torch.Tensor  # [B, K-1, w] — the last K-1 pre-conv inputs
    h: torch.Tensor  # [B, w] fp32


def _width(cfg: ModelConfig) -> int:
    return cfg.griffin.lru_width or cfg.d_model


def lam_init(w: int) -> torch.Tensor:
    """The reference's Λ init (``griffin.py:57-60``), float32: a ∈ (0.9,
    0.999) at r = 1."""
    a = torch.linspace(0.9, 0.999, w, dtype=torch.float32)
    return torch.log(torch.expm1(-torch.log(a) / _C))


class Recurrent(nn.Module):
    """``proj_rec`` / ``proj_gate`` [d, w], ``conv_w`` [K, w], ``conv_b``
    [w], ``w_a`` / ``w_x`` [w, w], ``b_a`` / ``b_x`` [w], ``lam`` [w] and
    ``proj_out`` [w, d], all in the model's dtype (the reference's
    ``init_recurrent``)."""

    AXES = {"proj_rec": ("embed", "lru"), "proj_gate": ("embed", "lru"),
            "conv_w": ("conv", "lru"), "conv_b": ("lru",), "w_a": ("lru", "lru"),
            "b_a": ("lru",), "w_x": ("lru", "lru"), "b_x": ("lru",), "lam": ("lru",),
            "proj_out": ("lru", "embed")}

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, w, K = cfg.d_model, _width(cfg), cfg.griffin.conv_width
        self.proj_rec = layers._param((d, w), dtype, device)
        self.proj_gate = layers._param((d, w), dtype, device)
        self.conv_w = layers._param((K, w), dtype, device)
        self.conv_b = layers._param((w,), dtype, device)
        self.w_a = layers._param((w, w), dtype, device)
        self.b_a = layers._param((w,), dtype, device)
        self.w_x = layers._param((w, w), dtype, device)
        self.b_x = layers._param((w,), dtype, device)
        self.lam = layers._param((w,), dtype, device)
        self.proj_out = layers._param((w, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("proj_rec", "proj_gate", "w_a", "w_x", "proj_out"):
            layers.dense_(getattr(self, name), gen)
        layers.dense_(self.conv_w, gen, fan_in=self.conv_w.shape[0])
        with torch.no_grad():
            for b in (self.conv_b, self.b_a, self.b_x):
                b.zero_()
            self.lam.copy_(lam_init(self.lam.shape[0]))


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds (the reference's order):
    x [B, L, C], w [K, C], b [C]."""
    K, L = w.shape[0], x.shape[1]
    out = x * w[K - 1]
    for i in range(1, K):
        # x shifted i positions later, zeros first
        zeros = x.new_zeros((x.shape[0], min(i, L), x.shape[2]))
        shifted = torch.cat([zeros, x[:, : L - i]], dim=1) if i < L else zeros
        out = out + shifted * w[K - 1 - i]
    return out + b


def conv_state(raw: torch.Tensor, K: int) -> torch.Tensor:
    """The last K−1 pre-conv inputs [B, K−1, C], left-padded with zeros; a
    copy, so that the cache does not hold the whole [B, L, C] input."""
    state = raw[:, -(K - 1):]
    pad = K - 1 - state.shape[1]
    return F.pad(state, (0, 0, pad, 0)) if pad > 0 else state.clone()


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``.  On DTensors whose channels are sharded alike (x's
    and both of w's dims on ``model``) the product is a partial sum, which
    is reduce-scattered over its channels, as ``b``'s are, before the bias
    meets it (DTensor's own plan for that sum turns ``b`` into a partial
    sum, a redistribution some torch releases refuse)."""
    y = layers.linear(x, w)
    if isinstance(y, DTensor) and any(isinstance(p, Partial) for p in y.placements):
        y = y.redistribute(y.device_mesh, [Shard(y.dim() - 1) if isinstance(p, Partial)
                                           else p for p in y.placements])
    return y + b


def _gates(p: Recurrent, x: torch.Tensor):
    """x [..., w] fp32 → (a, gated input), the RG-LRU equations."""
    f32 = torch.float32
    r = torch.sigmoid(_affine(x, p.w_a.to(f32), p.b_a.to(f32)))
    i = torch.sigmoid(_affine(x, p.w_x.to(f32), p.b_x.to(f32)))
    log_a = -_C * F.softplus(p.lam.to(f32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * x)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t·h_{t−1} + b_t`` (h_{−1} = 0) along dim 1, as a log-depth
    inclusive scan of ``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``: after
    the step of shift s, position t holds the composition of the (up to)
    2s pairs ending at t."""
    L = a.shape[1]
    shift = 1
    while shift < L:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def rec_block_full(p: Recurrent, xin: torch.Tensor, cfg: ModelConfig):
    """Prefill / train.  xin [B, L, d] → (y [B, L, d], final RecCache)."""
    gate = layers._gelu(layers.linear(xin, p.proj_gate))
    xr_raw = layers.linear(xin, p.proj_rec)
    xr = causal_conv(xr_raw, p.conv_w, p.conv_b)
    a, b = _gates(p, xr.float())
    h_all = linear_scan(a, b)
    y = layers.linear(h_all.to(xin.dtype) * gate, p.proj_out)
    return y, RecCache(conv=conv_state(xr_raw, cfg.griffin.conv_width),
                       h=h_all[:, -1].clone())  # not a view that keeps h_all


def init_rec_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> RecCache:
    w, K = _width(cfg), cfg.griffin.conv_width
    return RecCache(conv=torch.zeros((batch, K - 1, w), dtype=dtype, device=device),
                    h=torch.zeros((batch, w), dtype=torch.float32, device=device))


def rec_block_decode(p: Recurrent, xin: torch.Tensor, cfg: ModelConfig, cache: RecCache):
    """One token.  xin [B, 1, d] → (y [B, 1, d], new RecCache)."""
    gate = layers._gelu(layers.linear(xin, p.proj_gate))  # [B, 1, w]
    xr_raw = layers.linear(xin, p.proj_rec)  # [B, 1, w]
    window = torch.cat([cache.conv, xr_raw], dim=1)  # [B, K, w]
    xr = torch.einsum("bkw,kw->bw", window, p.conv_w) + p.conv_b
    a, b = _gates(p, xr.float())  # [B, w]
    h = a * cache.h + b
    y = layers.linear(h[:, None, :].to(xin.dtype) * gate, p.proj_out)
    return y, RecCache(conv=window[:, 1:], h=h)
