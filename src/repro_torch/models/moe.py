"""Mixture-of-experts FFN with sort-based capacity dispatch.

The port of the reference's ``repro.models.moe.moe_fwd`` (its single-device
path; the expert-parallel ``shard_map`` path waits for a partitioner).
Tokens are routed top-k in float32 (ties to the lower expert id, as
``jax.lax.top_k``), the weights renormalised, the (token, expert)
assignments sorted by expert id (stable) and scattered into an ``[E, C,
d]`` buffer at their rank within the expert; ranks ≥ C are dropped (read
as zero on the combine).  Capacity ``C = N·k`` when ``exact`` (decode),
else ``max(1, round(N·k / E · capacity_factor))`` with Python's
half-to-even ``round``; ``N = B·S`` counts pad tokens, which take capacity
as in the reference.  The expert FFNs are three batched products over the
buffer; the shared expert (llama4) is added after the combine, the dense
residual (arctic) in the block.  Returns the Switch-style load-balance
``aux`` and the number of dropped assignments (a device tensor: no host
read on the way).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


class MoE(nn.Module):
    """``router`` [d, E], ``w_gate`` / ``w_up`` [E, d, f], ``w_down`` [E, f,
    d] and, with ``shared_expert``, ``shared`` (a swiglu :class:`MLP` of
    width f) — the reference's ``init_moe``.  ``dropped`` counts the
    assignments dropped over every forward since the last
    :meth:`reset_dropped` (a device tensor, outside the state dict)."""

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        e = cfg.moe
        d, f, E = cfg.d_model, e.d_ff_expert, e.n_experts
        self.router = layers._param((d, E), dtype, device)
        self.w_gate = layers._param((E, d, f), dtype, device)
        self.w_up = layers._param((E, d, f), dtype, device)
        self.w_down = layers._param((E, f, d), dtype, device)
        if e.shared_expert:
            self.shared = layers.MLP(d, f, "swiglu", dtype, device)
        self.register_buffer("dropped", torch.zeros((), dtype=torch.int64, device=device),
                             persistent=False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        layers.normal_(self.router, gen, 0.02)
        d, f = self.w_gate.shape[1], self.w_gate.shape[2]
        layers.dense_(self.w_gate, gen, fan_in=d)
        layers.dense_(self.w_up, gen, fan_in=d)
        layers.dense_(self.w_down, gen, fan_in=f)
        if hasattr(self, "shared"):
            self.shared.reset_parameters(gen)

    def reset_dropped(self) -> None:
        self.dropped.zero_()

    def forward(self, x: torch.Tensor, cfg: ModelConfig, exact: bool = False,
                count: bool = True):
        """``count=False``: this run's drops are not added to ``dropped``
        (a train step's backward recomputes the layer)."""
        y, aux, dropped = moe_fwd(self, x, cfg, exact=exact)
        if count:
            self.dropped.add_(dropped)
        return y, aux


def capacity(N: int, cfg: ModelConfig, exact: bool) -> int:
    e = cfg.moe
    return N * e.top_k if exact else max(1, int(round(N * e.top_k / e.n_experts
                                                      * e.capacity_factor)))


def route(router: torch.Tensor, xf: torch.Tensor, k: int):
    """float32 router → (probs [N, E], top_w [N, k] renormalised, top_i
    [N, k]); on equal probabilities the lower expert id comes first."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    top_i = torch.sort(-probs, dim=-1, stable=True).indices[:, :k]
    top_w = probs.gather(1, top_i)
    return probs, top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9), top_i


def moe_fwd(p: MoE, x: torch.Tensor, cfg: ModelConfig, exact: bool = False):
    """x [B, S, d] → (y [B, S, d], aux fp32 scalar, dropped assignments
    (int64 scalar))."""
    e = cfg.moe
    B, S, d = x.shape
    N, E, k = B * S, e.n_experts, e.top_k
    xf = x.reshape(N, d)
    probs, top_w, top_i = route(p.router, xf, k)

    # Switch-style load-balance aux: E · Σ_e frac_tokens_e · mean_prob_e
    eid = top_i.reshape(-1)  # [N·k]
    # (bincount would read the largest id back to the host: one sync a layer)
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    aux = E * torch.sum(counts.float() / (N * k) * probs.mean(0))

    # assignments sorted by expert id; the slot is the rank within the expert
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    tok_s = order // k
    w_s = top_w.reshape(-1)[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(N * k, device=x.device) - starts[eid_s]
    C = capacity(N, cfg, exact)
    keep = slot < C
    # the buffer's rows flattened (e, c) → e·C + c, dropped assignments sent
    # to one extra row that nothing reads
    row = torch.where(keep, eid_s * C + slot, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[row] = xf[tok_s]
    buf = buf[: E * C].view(E, C, d)

    g = F.silu(torch.bmm(buf, p.w_gate))
    h = g * torch.bmm(buf, p.w_up)
    out = torch.bmm(h, p.w_down).view(E * C, d)

    gathered = torch.where(keep[:, None], out[row.clamp_max(E * C - 1)], 0)
    y = torch.zeros((N, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok_s, gathered * w_s[:, None].to(x.dtype))
    if e.shared_expert:
        y = y + p.shared(xf)
    return y.reshape(B, S, d), aux, (~keep).sum()
