"""Shared building blocks of the decoder: norms, softcap, RoPE/M-RoPE, MLPs.

The functions follow the reference's ``repro.models.layers`` one for one
(same names, same arithmetic and dtypes); the modules hold parameters under
the reference's names and shapes, so a reference parameter tree maps onto
them leaf for leaf (``repro_torch.interop.params_from_jax``).  Parameters
are created empty on their device and filled by ``reset_parameters`` from
a ``torch.Generator`` at ``ParamBuilder``'s scales: dense ``N(0, 1/fan_in)``
(fan_in = the first axis unless stated), embeddings ``N(0, 0.02²)``, norm
scales and biases 0.  The normals are drawn in float32 and cast, as the
reference does; the numbers differ from ``jax.random``'s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(1 + w) convention (init w = 0); accumulation in fp32."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / theta**exps


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Standard rotate-half RoPE.  x [..., S, H, hd], positions [..., S]."""
    inv = _rope_inv_freq(x.shape[-1], theta, x.device)  # [hd/2]
    angles = positions[..., None].float() * inv  # [..., S, hd/2]
    return _rotate(x, angles[..., None, :])  # broadcast over heads


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions [3, ..., S] — (t, h, w) streams,
    each driving its ``sections`` share of the hd/2 frequency dims."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2={hd // 2}")
    inv = _rope_inv_freq(hd, theta, x.device)
    sel = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])  # [hd/2] stream per freq
    pos_per_freq = positions.float()[sel].movedim(0, -1)  # [..., S, hd/2]
    return _rotate(x, (pos_per_freq * inv)[..., None, :])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 3-D operands with float32 accumulation and output, as
    jnp's ``preferred_element_type=float32``: for bfloat16 on the card one
    product with a float32 output (no float32 copy of either operand)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _MmF32(torch.autograd.Function):
    """``a @ b`` of two bf16 matrices on the card with a float32 output
    (``torch.mm(..., out_dtype=float32)``, which has no derivative), and its
    gradient: the float32 cotangent rounded to the operands' dtype, each
    product accumulated in float32 and rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.t(), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.t(), g, out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for bf16 matrices on the card, accumulated and returned in
    float32 (jnp's ``preferred_element_type``), under autograd too."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MmF32.apply(a, b)
    return torch.mm(a, b, out_dtype=torch.float32)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def normal_(p: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """``p ← scale · N(0, 1)``, drawn in float32 and cast (``normal_init``)."""
    p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float32, device=p.device) * scale)


def dense_(p: torch.Tensor, gen: torch.Generator, fan_in: int | None = None) -> None:
    fan_in = fan_in if fan_in is not None else p.shape[0]
    normal_(p, gen, 1.0 / math.sqrt(max(1, fan_in)))


class RMSNorm(nn.Module):
    """``{"scale": [dim] float32}``, the reference's ``init_rms_norm``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = _param((dim,), torch.float32, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class MLP(nn.Module):
    """``gate`` / ``up`` [d, f] and ``down`` [f, d] (no ``gate`` for the
    plain ``gelu`` kind): swiglu, geglu (tanh GELU) or gelu."""

    KINDS = ("swiglu", "geglu", "gelu")

    def __init__(self, d_model: int, d_ff: int, kind: str, dtype, device=None):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"unknown mlp kind {kind!r}")
        self.kind = kind
        if kind != "gelu":
            self.gate = _param((d_model, d_ff), dtype, device)
        self.up = _param((d_model, d_ff), dtype, device)
        self.down = _param((d_ff, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in self.parameters():
            dense_(p, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "gelu":
            return _gelu(x @ self.up) @ self.down
        act = F.silu if self.kind == "swiglu" else _gelu
        return (act(x @ self.gate) * (x @ self.up)) @ self.down
