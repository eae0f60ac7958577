"""Mixture-of-experts FFN with sort-based capacity dispatch.

The port of the reference's ``repro.models.moe.moe_fwd``, its single-device
path and its expert-parallel path (``_moe_ep``, the reference's
``_moe_ep_shardmap``).
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

Under a partitioner whose mesh has a ``model`` axis dividing E (train and
prefill: not ``exact``), the expert-parallel path runs each rank's part
through :meth:`Partitioner.local`: the tokens of its data shard (``N_loc =
N / dp`` of them, replicated over ``model``), the E / tp experts of its
model shard; it dispatches the assignments to its own experts (the others
are masked), with the capacity of ``N_loc`` tokens (drops are per data
shard), and the combine is one sum over ``model`` (a ``Partial`` output
made ``Replicate``).  The shared expert is added after the combine.
Otherwise under a partitioner (decode, or E not divisible) the
single-device path runs on DTensors with the reference's constraints (the
buffer expert-major on ``model``, the experts' output and the combined
tokens ``d``-major, ``moe_d``); its routing, sort, scatter and combine run
on whole tensors on every rank (``_whole``: DTensor has no sharding rule
for them in every torch release).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.dist.partition import even, reshape
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


class MoE(nn.Module):
    """``router`` [d, E], ``w_gate`` / ``w_up`` [E, d, f], ``w_down`` [E, f,
    d] and, with ``shared_expert``, ``shared`` (a swiglu :class:`MLP` of
    width f) — the reference's ``init_moe``.  ``dropped`` counts the
    assignments dropped over every forward since the last
    :meth:`reset_dropped` (a device tensor, outside the state dict)."""

    AXES = {"router": ("embed", "experts"), "w_gate": ("experts", "embed", "ffn"),
            "w_up": ("experts", "embed", "ffn"), "w_down": ("experts", "ffn", "embed")}

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
                count: bool = True, shard=None):
        """``count=False``: this run's drops are not added to ``dropped``
        (a train step's backward recomputes the layer)."""
        y, aux, dropped = moe_fwd(self, x, cfg, exact=exact, shard=shard)
        if count:
            if isinstance(dropped, DTensor):
                # summed over the data shards on the device; the count is a
                # (replicated) DTensor from then on
                mesh = dropped.device_mesh
                self.dropped = dropped.redistribute(mesh, [Replicate()] * mesh.ndim) \
                    + self.dropped
            else:
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


def _expert_parallel(shard, cfg: ModelConfig, exact: bool) -> bool:
    """The reference's condition for its expert-parallel path."""
    return (not exact and shard is not None and shard.mesh is not None
            and shard.constrain_attention and "model" in shard.shape
            and cfg.moe.n_experts % shard.shape["model"] == 0)


def _moe_ep(p: MoE, xf, top_w, top_i, cfg: ModelConfig, shard):
    """The reference's ``_moe_ep_shardmap``: explicit expert parallelism
    over ``model``.  Each rank runs the body on its data shard's tokens and
    its model shard's experts; returns (y [N, d] replicated over
    ``model``, the dropped assignments summed over the data shards)."""
    e = cfg.moe
    E, k = e.n_experts, e.top_k
    tp = shard.shape["model"]
    E_loc = E // tp
    N = xf.shape[0]
    dp = shard.axis_size(("pod", "data"))
    if N % dp:
        raise ValueError(f"the expert-parallel MoE splits its {N} tokens over {dp} data shards")
    N_loc = N // dp
    C = max(1, int(round(N_loc * k / E * e.capacity_factor)))
    mesh_axes = tuple(shard.shape)
    tok_pl = tuple(Shard(0) if a in ("pod", "data") else Replicate() for a in mesh_axes)
    w_pl = tuple(Shard(0) if a == "model" else Replicate() for a in mesh_axes)
    y_pl = tuple(Shard(0) if a in ("pod", "data") else
                 Partial() if a == "model" else Replicate() for a in mesh_axes)
    drop_pl = tuple(Partial() if a in ("pod", "data") else Replicate() for a in mesh_axes)

    def body(xl, wl, il, wg, wu, wd):
        r = shard.coordinate(("model",))
        eid = il.reshape(-1)  # [N_loc·k]
        order = torch.argsort(eid, stable=True)
        eid_s = eid[order]
        tok_s = order // k
        w_s = wl.reshape(-1)[order]
        counts = torch.zeros(E, dtype=torch.int64, device=xl.device).scatter_add_(
            0, eid, torch.ones_like(eid))
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(N_loc * k, device=xl.device) - starts[eid_s]
        # only this shard's experts; the others' assignments are masked
        eidx = eid_s - r * E_loc
        keep = (eidx >= 0) & (eidx < E_loc) & (slot < C)
        row = torch.where(keep, eidx * C + slot, E_loc * C)
        buf = torch.zeros((E_loc * C + 1, xl.shape[1]), dtype=xl.dtype, device=xl.device)
        buf[row] = xl[tok_s]
        buf = buf[: E_loc * C].view(E_loc, C, -1)
        h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        out = torch.bmm(h, wd).view(E_loc * C, -1)
        contrib = torch.where(keep[:, None], out[row.clamp_max(E_loc * C - 1)], 0)
        y = torch.zeros_like(xl).index_add_(0, tok_s, contrib * w_s[:, None].to(xl.dtype))
        # over capacity, whichever shard owns the expert: the same count on
        # every model shard of a data shard
        return y, (slot >= C).sum()

    y, dropped = shard.local(body, (y_pl, drop_pl),
                             (tok_pl, tok_pl, tok_pl, w_pl, w_pl, w_pl))(
        *(shard.as_dtensor(t) for t in (xf, top_w, top_i, p.w_gate, p.w_up, p.w_down)))
    return y.redistribute(shard.device_mesh, [Replicate() if isinstance(pl, Partial) else pl
                                              for pl in y_pl]), dropped


def _whole(shard, fn, n_out: int, *args):
    """``fn(*args)``; on DTensors each rank runs it on the whole, replicated
    tensors (the dispatch's sorting and scattering, which DTensor has no
    sharding rule for in every torch release)."""
    if shard is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    rep = list(shard.replicated().placements)
    outs = tuple(list(rep) for _ in range(n_out)) if n_out > 1 else rep
    return shard.local(fn, outs, tuple(list(rep) for _ in args))(
        *(shard.as_dtensor(a) for a in args))


def _sorted(top_i, E: int, k: int, C: int):
    """The sort-based dispatch of the assignments ``top_i`` [N, k] at
    capacity C: (order, counts [E], keep, row) — the assignments in expert
    order (stable), each expert's count, whether each sorted assignment is
    kept (its rank within the expert < C), and its row ``e·C + rank`` of
    the flattened [E·C] buffer (E·C, a row nothing reads, where dropped)."""
    eid = top_i.reshape(-1)  # [N·k]
    # (bincount would read the largest id back to the host: one sync a layer)
    counts = torch.zeros(E, dtype=torch.int64, device=eid.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(eid.shape[0], device=eid.device) - starts[eid_s]
    keep = slot < C
    return order, counts, keep, torch.where(keep, eid_s * C + slot, E * C)


def moe_fwd(p: MoE, x: torch.Tensor, cfg: ModelConfig, exact: bool = False, shard=None):
    """x [B, S, d] → (y [B, S, d], aux fp32 scalar, dropped assignments
    (int64 scalar)).  ``shard``: a partitioner (see the module's note)."""
    e = cfg.moe
    B, S, d = x.shape
    N, E, k = B * S, e.n_experts, e.top_k
    xf = reshape(even(x), N, d)
    probs, top_w, top_i = _whole(shard, lambda r, xl: route(r, xl, k), 3, p.router, xf)

    if _expert_parallel(shard, cfg, exact):
        counts = _whole(shard, lambda ti: _sorted(ti, E, k, 1)[1], 1, top_i)
        aux = E * torch.sum(counts.float() / (N * k) * probs.mean(0))
        y, dropped = _moe_ep(p, xf, top_w, top_i, cfg, shard)
        if e.shared_expert:
            y = y + p.shared(xf)
        return reshape(y, B, S, d), aux, dropped

    C = capacity(N, cfg, exact)
    order, counts, keep, row = _whole(shard, lambda ti: _sorted(ti, E, k, C), 4, top_i)
    # Switch-style load-balance aux: E · Σ_e frac_tokens_e · mean_prob_e
    aux = E * torch.sum(counts.float() / (N * k) * probs.mean(0))

    def scatter(xl, order_l, row_l):
        buf = torch.zeros((E * C + 1, d), dtype=xl.dtype, device=xl.device)
        buf[row_l] = xl[order_l // k]
        return buf[: E * C].view(E, C, d)

    buf = _whole(shard, scatter, 1, xf, order, row)
    if shard is not None:
        buf = shard(buf, "experts", None, None)
    g = F.silu(layers.local_product(torch.bmm, buf, p.w_gate))
    h = g * layers.local_product(torch.bmm, buf, p.w_up)
    out = layers.local_product(torch.bmm, h, p.w_down)
    if shard is not None and shard.constrain_attention:
        out = shard(out, None, None, "moe_d")

    def combine(out_l, w_l, order_l, keep_l, row_l):
        flat = out_l.reshape(E * C, d)
        gathered = torch.where(keep_l[:, None], flat[row_l.clamp_max(E * C - 1)], 0)
        w_s = w_l.reshape(-1)[order_l]
        return torch.zeros((N, d), dtype=flat.dtype, device=flat.device).index_add_(
            0, order_l // k, gathered * w_s[:, None].to(flat.dtype))

    y = _whole(shard, combine, 1, out, top_w, order, keep, row)
    if shard is not None and shard.constrain_attention:
        y = shard(y, None, "moe_d")
    if e.shared_expert:
        y = y + p.shared(xf)
    return reshape(y, B, S, d), aux, (~keep).sum()
