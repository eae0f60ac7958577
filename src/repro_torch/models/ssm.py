"""Mamba-2 SSD (state-space duality) blocks: the chunked prefill path and
the O(1)-state decode path.

The port of the reference's ``repro.models.ssm``.  The chunked algorithm
(arXiv:2405.21060 §6) splits the sequence into chunks of Q tokens: within
a chunk the output is an attention-like quadratic term (``y_diag``),
across chunks a linear recurrence over per-chunk states carries the
long-range part (``y_off``; a loop over the L / Q chunks).  Decode keeps
the recurrent view: ``h ← exp(dt·A)·h + dt·(B ⊗ x)``; ``y = C·h + D·x``.
The state and the SSD arithmetic are float32; ``norm`` is a float32
``(1 + w)`` rms-norm weight even in a bfloat16 model.  A prefill of L
tokens runs in chunks of ``min(chunk_size, L)`` and raises ``ValueError``
unless L is a multiple of it, as the reference does.  Left pads run
through the recurrence, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.partition import Partitioner, reshape
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.griffin import causal_conv, conv_state


class SSMCache(NamedTuple):
    conv: torch.Tensor  # [B, K-1, conv_dim] — the last K-1 pre-conv inputs
    h: torch.Tensor  # [B, H, P, N] fp32 — the SSD state


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_size
    return s, d_in, H, conv_dim


def value_init(H: int) -> dict:
    """The reference's value leaves (``ssm.py:44-46``), float32."""
    return {"A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32)),
            "D": torch.ones(H, dtype=torch.float32),
            "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, dtype=torch.float32)))}


class SSD(nn.Module):
    """``in_proj`` [d, 2·d_in + 2·G·N + H] (z, xBC, dt), ``conv_w`` [K,
    conv_dim], ``conv_b`` [conv_dim], ``A_log`` / ``D`` / ``dt_bias`` [H]
    and ``out_proj`` [d_in, d] in the model's dtype, ``norm`` [d_in]
    float32 (the reference's ``init_ssd``)."""

    AXES = {"in_proj": ("embed", "inner"), "conv_w": ("conv", "inner"), "conv_b": ("inner",),
            "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",), "norm": ("inner",),
            "out_proj": ("inner", "embed")}

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        s, d_in, H, conv_dim = _dims(cfg)
        d = cfg.d_model
        self.in_proj = layers._param((d, 2 * d_in + 2 * s.n_groups * s.state_size + H), dtype,
                                     device)
        self.conv_w = layers._param((s.conv_width, conv_dim), dtype, device)
        self.conv_b = layers._param((conv_dim,), dtype, device)
        self.A_log = layers._param((H,), dtype, device)
        self.D = layers._param((H,), dtype, device)
        self.dt_bias = layers._param((H,), dtype, device)
        self.norm = layers._param((d_in,), torch.float32, device)
        self.out_proj = layers._param((d_in, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        layers.dense_(self.in_proj, gen)
        layers.dense_(self.conv_w, gen, fan_in=self.conv_w.shape[0])
        layers.dense_(self.out_proj, gen)
        with torch.no_grad():
            self.conv_b.zero_()
            self.norm.zero_()
            for name, value in value_init(self.A_log.shape[0]).items():
                getattr(self, name).copy_(value)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    s, d_in, H, _ = _dims(cfg)
    gn = s.n_groups * s.state_size
    return torch.split(proj, [d_in, d_in + 2 * gn, H], dim=-1)  # z, xBC, dt


def _split_xbc(cfg: ModelConfig, xBC: torch.Tensor):
    s, d_in, H, _ = _dims(cfg)
    gn = s.n_groups * s.state_size
    x, Bm, Cm = torch.split(xBC, [d_in, gn, gn], dim=-1)
    lead = tuple(x.shape[:-1])
    return (reshape(x, *lead, H, s.head_dim), reshape(Bm, *lead, s.n_groups, s.state_size),
            reshape(Cm, *lead, s.n_groups, s.state_size))


def _per_rank(fn, x, G: int, args, dims, out_dims):
    """``fn(*args)`` on DTensors, on each rank's local tensors: its batch
    rows (the mesh dims ``x`` [B, ..., H, ...] is batch-sharded on) and,
    on ``model`` where it divides H and one group serves every head, its
    heads — every SSD step is independent across both.  ``dims[i]`` is
    ``(batch dim, head dim)`` of ``args[i]`` (None: not there);
    ``out_dims`` likewise for the outputs."""
    mesh = x.device_mesh
    H = x.shape[2]
    split = []
    for i, p in enumerate(x.placements):
        if type(p) is Shard and p.dim == 0:
            split.append(0)
        elif mesh.mesh_dim_names[i] == "model" and G == 1 and H % mesh.size(i) == 0:
            split.append(1)
        else:
            split.append(None)

    def pl(d):
        return [Replicate() if k is None or d[k] is None else Shard(d[k]) for k in split]

    part = Partitioner(mesh)
    return part.local(fn, tuple(pl(d) for d in out_dims), tuple(pl(d) for d in dims))(
        *(part.as_dtensor(a) for a in args))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., Q] → [..., Q, Q]: s[i, j] = Σ_{j<k≤i} a_k (−inf for i < j)."""
    Q = a.shape[-1]
    cs = layers.cumsum(a, -1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, s, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """x [B, L, H, P], dt [B, L, H] (post-softplus), A [H] (negative), Bm /
    Cm [B, L, G, N] → (y [B, L, H, P] fp32, final state [B, H, P, N] fp32).
    Raises ``ValueError`` unless L is a multiple of ``chunk``."""
    B_, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    r = H // G
    if L % chunk:
        raise ValueError(f"L={L} must be divisible by chunk={chunk}")
    nc = L // chunk
    f32 = torch.float32
    u = (x * dt[..., None]).to(f32)  # discretized input
    dA = (dt * A).to(f32)  # [B, L, H]

    uc = u.reshape(B_, nc, chunk, H, P)
    dAc = dA.reshape(B_, nc, chunk, H)
    Bh = Bm.reshape(B_, nc, chunk, G, N).to(f32).repeat_interleave(r, dim=3)  # [B, nc, Q, H, N]
    Ch = Cm.reshape(B_, nc, chunk, G, N).to(f32).repeat_interleave(r, dim=3)

    # 1. intra-chunk (attention-like with a decay kernel)
    Lk = torch.exp(_segsum(dAc.movedim(3, 2)))  # [B, nc, H, Q, Q]
    scores = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores * Lk, uc)

    # 2. per-chunk states: S_c = Σ_j exp(Σ_{k>j} dA) B_j ⊗ u_j
    cums = layers.cumsum(dAc, 2)  # [B, nc, Q, H]
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)
    S = torch.einsum("bcjhn,bcjhp->bchpn", Bh * decay_to_end[..., None], uc)

    # 3. inter-chunk recurrence over the states (the state before each chunk)
    chunk_decay = torch.exp(cums[:, :, -1, :])  # [B, nc, H]
    h = torch.zeros((B_, H, P, N), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # [B, nc, H, P, N]

    # 4. the chunk-start state's contribution
    state_decay = torch.exp(cums)  # [B, nc, Q, H]
    y_off = torch.einsum("bcihn,bchpn->bcihp", Ch * state_decay[..., None], h_prev)
    return (y_diag + y_off).reshape(B_, L, H, P), h


def _gate_norm(p: SSD, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    return layers.rms_norm((y * F.silu(z.float())).to(dtype), p.norm)


def ssd_block_full(p: SSD, xin: torch.Tensor, cfg: ModelConfig):
    """Prefill / train.  xin [B, L, d] → (y [B, L, d], final SSMCache)."""
    s, d_in, H, _ = _dims(cfg)
    z, xBC_raw, dt_raw = _split_proj(cfg, layers.linear(xin, p.in_proj))
    xBC = F.silu(causal_conv(xBC_raw, p.conv_w, p.conv_b))
    x, Bm, Cm = _split_xbc(cfg, xBC)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log.float())
    chunk = min(s.chunk_size, xin.shape[1])
    if isinstance(x, DTensor):
        y, h = _per_rank(lambda *a: ssd_chunked(*a, chunk), x, s.n_groups, (x, dt, A, Bm, Cm),
                         ((0, 2), (0, 2), (None, 0), (0, None), (0, None)),
                         ((0, 2), (0, 1)))
    else:
        y, h = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    y = y + p.D.float()[:, None] * x.float()
    y = _gate_norm(p, reshape(y, *xin.shape[:2], d_in), z, xin.dtype)
    cache = SSMCache(conv=conv_state(xBC_raw, s.conv_width).to(xin.dtype), h=h)
    return layers.linear(y, p.out_proj), cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None) -> SSMCache:
    s, d_in, H, conv_dim = _dims(cfg)
    return SSMCache(
        conv=torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
        h=torch.zeros((batch, H, s.head_dim, s.state_size), dtype=torch.float32,
                      device=device))


def _ssd_step(x, Bm, Cm, dt, A, D, h):
    """One token's state update: x [B, 1, H, P], Bm / Cm [B, 1, G, N], dt
    [B, H], A and D [H], h [B, H, P, N] → (y [B, H, P], new h)."""
    r = x.shape[2] // Bm.shape[2]
    x1 = x[:, 0].float()  # [B, H, P]
    B1 = Bm[:, 0].float().repeat_interleave(r, dim=1)  # [B, H, N]
    C1 = Cm[:, 0].float().repeat_interleave(r, dim=1)
    g = torch.exp(dt * A)  # [B, H]
    h = h * g[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt, B1, x1)
    return torch.einsum("bhpn,bhn->bhp", h, C1) + D.float()[:, None] * x1, h


def ssd_block_decode(p: SSD, xin: torch.Tensor, cfg: ModelConfig, cache: SSMCache):
    """One token.  xin [B, 1, d] → (y [B, 1, d], new SSMCache)."""
    s, d_in, H, _ = _dims(cfg)
    z, xBC_raw, dt_raw = _split_proj(cfg, layers.linear(xin, p.in_proj))
    window = torch.cat([cache.conv, xBC_raw], dim=1)  # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    x, Bm, Cm = _split_xbc(cfg, F.silu(conv_out)[:, None, :])
    dt = F.softplus(dt_raw.float() + p.dt_bias)[:, 0]  # [B, H]
    A = -torch.exp(p.A_log.float())
    if isinstance(x, DTensor):
        y, h = _per_rank(_ssd_step, x, s.n_groups, (x, Bm, Cm, dt, A, p.D, cache.h),
                         ((0, 2), (0, None), (0, None), (0, 1), (None, 0), (None, 0), (0, 1)),
                         ((0, 1), (0, 1)))
    else:
        y, h = _ssd_step(x, Bm, Cm, dt, A, p.D, cache.h)
    y = _gate_norm(p, reshape(y, xin.shape[0], 1, d_in), z, xin.dtype)
    return layers.linear(y, p.out_proj), SSMCache(conv=window[:, 1:], h=h)
