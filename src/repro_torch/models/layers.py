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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.partition import Partitioner, even


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


def local_product(fn, a, b):
    """``fn(a, b)``, a matrix product (``mm`` of [M, K] by [K, N], or ``bmm``
    of [G, M, K] by [G, K, N]), on DTensor operands by their local tensors:
    per mesh dim the contraction is made whole (a dim sharded on K is
    gathered), a batch dim sharded in one operand is sharded in both, and
    rows and columns sharded on the same mesh dim keep the rows.  For the
    products that DTensor has no rule for (``out_dtype``); plain operands
    go straight to ``fn``."""
    if not isinstance(a, DTensor) and not isinstance(b, DTensor):
        return fn(a, b)
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    rep = [Replicate()] * mesh.ndim
    pa = list(a.placements) if isinstance(a, DTensor) else rep
    pb = list(b.placements) if isinstance(b, DTensor) else rep
    nd = a.dim()
    k_a, k_b, n_b = nd - 1, nd - 2, nd - 1
    out = []
    for i in range(mesh.ndim):
        da = pa[i].dim if isinstance(pa[i], Shard) else None
        db = pb[i].dim if isinstance(pb[i], Shard) else None
        if da == k_a or not isinstance(pa[i], (Shard, Replicate)):
            da = None
        if db == k_b or not isinstance(pb[i], (Shard, Replicate)):
            db = None
        if nd == 3 and 0 in (da, db):
            da = db = 0
        elif da is not None and db is not None:
            db = None
        pa[i] = Shard(da) if da is not None else Replicate()
        pb[i] = Shard(db) if db is not None else Replicate()
        out.append(Shard(da) if da is not None else Shard(n_b) if db is not None else Replicate())
    part = Partitioner(mesh)
    return part.local(fn, out, (pa, pb))(part.as_dtensor(a), part.as_dtensor(b))


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 3-D operands with float32 accumulation and output, as
    jnp's ``preferred_element_type=float32``: for bfloat16 on the card one
    product with a float32 output (no float32 copy of either operand)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return local_product(lambda x, y: torch.bmm(x, y, out_dtype=torch.float32), a, b)
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
        return local_product(_MmF32.apply, a, b)
    return local_product(lambda x, y: torch.mm(x, y, out_dtype=torch.float32), a, b)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., K] and w [K, N], as one [rows, K] × [K, N]
    product — what ``matmul`` folds it to.  On DTensors the product runs on
    each rank's local tensors (:func:`_local_linear`), with no view or
    product rule of DTensor's own."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return _local_linear(x, w)
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1], w.shape[-1])


def _local_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`linear` on DTensors, per mesh dim: rows of x sharded there
    stay sharded (w whole there); the contraction split in both x and w
    gives partial sums (Megatron's row-parallel product); else x is whole
    there and the output takes w's column shard, if any (a split of w's
    contraction alone, FSDP's, is gathered; a partial x is summed)."""
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    part = Partitioner(mesh)
    x, w = even(part.as_dtensor(x)), part.as_dtensor(w)
    nd = x.dim()
    xs, ws, out = [], [], []
    for px, pw in zip(x.placements, w.placements):
        dx = px.dim % nd if type(px) is Shard else None
        dw = pw.dim % 2 if type(pw) is Shard else None
        if dx is not None and dx < nd - 1:
            xs.append(Shard(dx))
            ws.append(Replicate())
            out.append(Shard(dx))
        elif dx == nd - 1 and dw == 0:
            xs.append(Shard(dx))
            ws.append(Shard(0))
            out.append(Partial())
        else:
            xs.append(Replicate())
            ws.append(Shard(1) if dw == 1 else Replicate())
            out.append(Shard(nd - 1) if dw == 1 else Replicate())

    def body(xl, wl):
        return (xl.reshape(-1, xl.shape[-1]) @ wl).reshape(*xl.shape[:-1], wl.shape[-1])

    return part.local(body, out, (xs, ws))(x, w)


def summed(y: torch.Tensor) -> torch.Tensor:
    """``y`` with its partial sums (a row-parallel product's, :func:`linear`)
    summed: what an MLP returns, and what a sublayer's output is before it
    joins the residual stream.  A partial sum would meet sharded operands
    in the ops after it, and DTensor's plan for such an op can turn the
    shard into a partial sum, which some torch releases refuse."""
    if isinstance(y, DTensor) and any(isinstance(p, Partial) for p in y.placements):
        return y.redistribute(y.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                              for p in y.placements])
    return y


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum``; on a DTensor each rank sums its local tensor along
    ``dim`` (made whole first where it is sharded), so that the gradient
    (the flipped cumsum of its gradient) is local too."""
    if not isinstance(x, DTensor):
        return torch.cumsum(x, dim)
    d = dim % x.dim()
    pl = [p if isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim != d)
          else Replicate() for p in x.placements]
    return Partitioner(x.device_mesh).local(lambda t: torch.cumsum(t, d), pl, (pl,))(x)


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

    AXES = {"scale": ("embed",)}

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
    AXES = {"gate": ("embed", "ffn"), "up": ("embed", "ffn"), "down": ("ffn", "embed")}

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
            return summed(linear(_gelu(linear(x, self.up)), self.down))
        act = F.silu if self.kind == "swiglu" else _gelu
        return summed(linear(act(linear(x, self.gate)) * linear(x, self.up), self.down))
