"""GQA attention: the full-sequence path through K7 and the cached decode.

The port of the reference's ``repro.models.attention``, in its
``[B, S, H, hd]`` layout.  ``attn_full`` (train) and ``attn_prefill`` run
the scores, softmax and ``P·V`` through K7's model-layout wrapper
(``repro_torch.kernels.flash_attention.blockwise_attention``: causal,
sliding window, logit softcap, left-pad ``valid_from``; its plain version
for CPU tensors); ``attn_decode`` is a plain one-token softmax over the
cache, as in the reference, which has no kernel there.

Caches: full caches ``[B, max_len, KV, hd]`` or ring-buffer window caches
``[B, window, KV, hd]`` with a per-slot position vector (``-1`` = empty or
pad: never attended).  Unlike the reference's pure functions, prefill and
decode write the cache tensors in place (no second copy of a cache is
held) and return the same ``KVCache``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG_INF = -(2.0**30)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, L, KV, hd]
    v: torch.Tensor  # [B, L, KV, hd]
    pos: torch.Tensor  # [B, L] int32: absolute position per slot (-1 = empty / pad)


class Attention(nn.Module):
    """``wq`` [d, H, hd], ``wk`` / ``wv`` [d, KV, hd], ``wo`` [H, hd, d] and,
    with ``qkv_bias``, ``bq`` [H, hd], ``bk`` / ``bv`` [KV, hd]."""

    AXES = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv", "head_dim"),
            "wv": ("embed", "kv", "head_dim"), "wo": ("heads", "head_dim", "embed"),
            "bq": ("heads", "head_dim"), "bk": ("kv", "head_dim"), "bv": ("kv", "head_dim")}

    def __init__(self, cfg: ModelConfig, dtype, device=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        self.wq = layers._param((d, H, hd), dtype, device)
        self.wk = layers._param((d, KV, hd), dtype, device)
        self.wv = layers._param((d, KV, hd), dtype, device)
        self.wo = layers._param((H, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = layers._param((H, hd), dtype, device)
            self.bk = layers._param((KV, hd), dtype, device)
            self.bv = layers._param((KV, hd), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("wq", "wk", "wv"):
            layers.dense_(getattr(self, name), gen)
        H, hd = self.wo.shape[:2]
        layers.dense_(self.wo, gen, fan_in=H * hd)
        with torch.no_grad():
            for name in ("bq", "bk", "bv"):
                if hasattr(self, name):
                    getattr(self, name).zero_()


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, heads, hd = w.shape
    return layers.linear(x, w.reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    H, hd, d = wo.shape
    return layers.linear(o.flatten(-2), wo.reshape(H * hd, d))


def _project_qkv(p: Attention, x, cfg: ModelConfig, rope_positions):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.rope_kind == "standard":
        q = layers.apply_rope(q, rope_positions, cfg.rope_theta)
        k = layers.apply_rope(k, rope_positions, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        q = layers.apply_mrope(q, rope_positions, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, rope_positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _mask(q_pos, kv_pos, window):
    """q_pos [..., S, 1], kv_pos [..., 1, T] → bool valid mask."""
    valid = (kv_pos <= q_pos) & (kv_pos >= 0)
    if window is not None:
        valid &= q_pos - kv_pos < window
    return valid


def _window_for(cfg: ModelConfig, kind: str) -> int | None:
    if kind == "attn_local":
        return cfg.attn_window or (cfg.griffin.attn_window if cfg.griffin else None)
    return None


def _constrain_q(q, shard):
    """The reference's ``_constrain_q``: heads-TP when the model axis divides
    the heads, else context parallelism (q sharded on the sequence over
    ``model``: K and V stay whole on every model shard), else q as it is.
    Returns ``(q, mode)``, mode ``"heads"``, ``"seq"`` or None."""
    if shard is None or not shard.constrain_attention:
        return q, None
    H, S = q.shape[2], q.shape[1]
    if shard.dim_shards("heads", H) > 1:
        return shard(q, "batch", None, "heads", None), "heads"
    if shard.dim_shards("seq_model", S) > 1:
        return shard(q, "batch", "seq_model", None, None), "seq"
    return q, None


def _attend(q, k, v, cfg: ModelConfig, kind: str, shard, valid_from=None):
    """K7 (and under autograd K7b) on the projected q, k, v.  Under a mesh
    (q a DTensor) each rank runs the kernel on its local tensors through
    :meth:`Partitioner.local`: its batch rows, and its query heads (heads
    mode) or its query rows at their offset ``r · S / tp`` into the keys
    (``seq`` mode); K and V are sharded by KV head where the model axis
    divides them in heads mode, else whole on each model shard, and their
    gradients are then partial sums over ``model``."""
    window, cap = _window_for(cfg, kind), cfg.attn_logit_softcap
    q, mode = _constrain_q(q, shard)
    if not isinstance(q, DTensor):
        return fa.blockwise_attention(q, k, v, window=window, logit_cap=cap,
                                      valid_from=valid_from)
    B, _, H, _ = q.shape
    KV = k.shape[2]
    G = H // KV
    tp = shard.axis_size(("model",))
    q_pl = shard.placements(shard.spec(
        ("batch", "seq_model" if mode == "seq" else None, "heads" if mode == "heads" else None,
         None), q.shape))
    kv_heads = mode == "heads" and KV % tp == 0
    kv_pl = shard.placements(shard.spec(("batch", None, "kv" if kv_heads else None, None),
                                        k.shape))
    batch_split = shard.dim_shards("batch", B) > 1

    def body(ql, kl, vl):
        vf = valid_from
        if vf is not None and batch_split:
            Bl = ql.shape[0]
            lo = shard.coordinate(("pod", "data")) * Bl
            vf = vf[lo: lo + Bl]
        q_off = 0
        if mode == "seq":
            q_off = shard.coordinate(("model",)) * ql.shape[1]
        elif mode == "heads" and not kv_heads:
            # this rank's query heads [r·Hl, (r+1)·Hl) read KV heads h // G
            Hl = ql.shape[2]
            h0 = shard.coordinate(("model",)) * Hl
            if G % Hl == 0:  # all in one KV head
                kl, vl = kl[:, :, h0 // G: h0 // G + 1], vl[:, :, h0 // G: h0 // G + 1]
            else:  # one KV head per query head
                idx = torch.arange(h0, h0 + Hl, device=kl.device) // G
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return fa.blockwise_attention(ql, kl, vl, window=window, logit_cap=cap,
                                      valid_from=vf, q_off=q_off)

    return shard.local(body, q_pl, (q_pl, kv_pl, kv_pl))(q, k, v)


def attn_full(p: Attention, x, cfg: ModelConfig, kind: str, rope_positions,
              shard=None) -> torch.Tensor:
    """Train/prefill full-sequence attention (no cache)."""
    q, k, v = _project_qkv(p, x, cfg, rope_positions)
    return _out(_attend(q, k, v, cfg, kind, shard), p.wo)


def init_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
               device=None) -> KVCache:
    window = _window_for(cfg, kind)
    L = min(window, max_len) if window else max_len
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, L, KV, hd), dtype=dtype, device=device),
        pos=torch.full((batch, L), -1, dtype=torch.int32, device=device),
    )


def pad_rows(v: torch.Tensor, H: int) -> torch.Tensor:
    """What the reference's prefill attention returns on a left-pad row,
    [B, H, hd] float32.  Such a row sees no valid key, so its blockwise scan
    (``kv_block = min(1024, S)``, keys zero-padded to whole blocks) keeps
    the running max at its −2³⁰ start and weighs every key by exp(0) = 1:
    the sum of V over the S keys over the padded key count.  K7 writes 0
    there.  Attention layers alone never read such a row, but a recurrence
    (``rec``, ``ssd``) runs through it and MoE routing counts it, so the
    port keeps the reference's value."""
    B, S, KV, hd = v.shape
    block = min(1024, S)
    keys = -(-S // block) * block
    mean = v.float().sum(1) / keys  # [B, KV, hd], each KV head's G query heads alike
    return mean[:, :, None].expand(B, KV, H // KV, hd).reshape(B, H, hd)


def attn_prefill(p: Attention, x, cfg: ModelConfig, kind: str, rope_positions,
                 cache: KVCache, valid_from=None, shard=None):
    """Full-sequence forward that also fills the cache (its last L positions).

    ``valid_from`` [B] marks the first real token per slot (left-padded
    serving batches); earlier slots get pos = -1 and are never attended,
    and their rows take the reference's value (:func:`pad_rows`).
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, rope_positions)
    pos = fa.positions_of(valid_from, B, S, x.device)
    out = _attend(q, k, v, cfg, kind, shard, valid_from)
    if valid_from is not None:
        fill = pad_rows(v, q.shape[2]).to(out.dtype)
        out = torch.where((pos < 0)[:, :, None, None], fill[:, None], out)
    L = cache.k.shape[1]
    if L >= S:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        cache.pos[:, :S] = pos
    else:  # keep the last L positions (ring layout: slot = pos % L)
        shift = S % L  # torch.roll by -shift along the positions, as two slices
        for dst, src in ((cache.k, k), (cache.v, v), (cache.pos, pos)):
            tail = src[:, -L:]
            dst.copy_(torch.cat([tail[:, shift:], tail[:, :shift]], dim=1))
    return _out(out, p.wo), cache


def attn_decode(p: Attention, x, cfg: ModelConfig, kind: str, rope_positions,
                cache: KVCache, t: int):
    """One-token decode.  x [B, 1, d]; t — absolute position (a plain int)."""
    q, k, v = _project_qkv(p, x, cfg, rope_positions)
    L = cache.k.shape[1]
    window = _window_for(cfg, kind)
    slot = t % L
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.pos[:, slot].fill_(t)
    B, _, H, hd = q.shape
    KV = cache.k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    # per batch row, one product batched over the KV heads, reading the
    # [L, KV, hd] cache in place: einsum("bkgh,btkh->bkgt") with fp32 output
    s = torch.stack([layers.bmm_f32(qg[b], cache.k[b].permute(1, 2, 0))
                     for b in range(B)]) / math.sqrt(hd)
    s = layers.softcap(s, cfg.attn_logit_softcap)
    valid = _mask(t, cache.pos[:, None, None, :], window)
    s = torch.where(valid, s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(cache.v.dtype)
    # einsum("bkgt,btkh->bkgh") in V's dtype
    out = torch.stack([torch.bmm(prob[b], cache.v[b].transpose(0, 1)) for b in range(B)])
    return _out(out.reshape(B, 1, H, hd), p.wo), cache
