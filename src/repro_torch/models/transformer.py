"""The decoder stack: train / prefill / decode for attention-only archs.

The port of the reference's ``repro.models.transformer`` for dense
(non-MoE) configs whose every layer is attention (``attn``,
``attn_local``, ``attn_global``) and whose inputs are token ids.  Layers
are a flat ``ModuleList`` in ``layer_pattern`` order (period after
period, then ``tail_pattern``), not the reference's scanned super-blocks;
``repro_torch.interop.params_from_jax`` maps the reference's stacked tree
onto it.

Modes of :meth:`Decoder.forward_hidden`:
  * train   — full sequence, no caches (the tests' full-forward oracle;
    training itself is not ported);
  * prefill — full sequence, fills the per-layer caches;
  * decode  — one token against the caches at absolute position ``t``.

The full-sequence attention runs through K7
(``repro_torch.kernels.flash_attention``; its plain version for CPU
tensors).  Parameters are created on ``device`` (CUDA unless the caller
says ``"cpu"``) and filled from ``seed`` with ``ParamBuilder``'s scales.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig

MODES = ("train", "prefill", "decode")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run yet."""
    kinds = set(cfg.layer_pattern)
    missing = []
    if kinds & {"rec", "ssd"}:
        missing.append(f"{sorted(kinds & {'rec', 'ssd'})} layers (griffin / SSM blocks)")
    if cfg.moe is not None:
        missing.append("mixture-of-experts layers")
    if cfg.input_mode != "tokens":
        missing.append(f"input_mode={cfg.input_mode!r} (precomputed embeddings)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port's decoder runs attention-only, dense, token-input "
            f"configs; not yet {', '.join(missing)} — ROADMAP A7 (the rest of the LM stack)"
        )


class Block(nn.Module):
    """One layer: ``pre_norm``, ``core`` (attention), ``post_norm``,
    ``pre_mlp_norm``, ``mlp``, ``post_mlp_norm`` (the post-norms with
    ``cfg.post_norm``), as in the reference's ``_init_block``."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device=None):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.pre_norm = layers.RMSNorm(d, device)
        self.core = attention.Attention(cfg, dtype, device)
        if cfg.post_norm:
            self.post_norm = layers.RMSNorm(d, device)
        self.pre_mlp_norm = layers.RMSNorm(d, device)
        self.mlp = layers.MLP(d, cfg.d_ff, cfg.mlp_kind, dtype, device)
        if cfg.post_norm:
            self.post_mlp_norm = layers.RMSNorm(d, device)

    def forward(self, x, cfg: ModelConfig, rope_pos, mode: str, cache, t, valid_from):
        h = self.pre_norm(x)
        if mode == "train":
            y = attention.attn_full(self.core, h, cfg, self.kind, rope_pos)
        elif mode == "prefill":
            y, cache = attention.attn_prefill(self.core, h, cfg, self.kind, rope_pos, cache,
                                              valid_from)
        else:
            y, cache = attention.attn_decode(self.core, h, cfg, self.kind, rope_pos, cache, t)
        if cfg.post_norm:
            y = self.post_norm(y)
        x = x + y
        y = self.mlp(self.pre_mlp_norm(x))
        if cfg.post_norm:
            y = self.post_mlp_norm(y)
        return x + y, cache


class Decoder(nn.Module):
    """``embed`` [V, d], ``final_norm``, ``unembed`` [d, V] (untied only) and
    ``layers`` — one :class:`Block` per layer."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int | None = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = DTYPES[cfg.dtype]
        self.embed = layers._param((cfg.vocab_size, cfg.d_model), dtype, dev)
        self.final_norm = layers.RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.unembed = layers._param((cfg.d_model, cfg.vocab_size), dtype, dev)
        # the reference's jnp.asarray(d_model ** 0.5, dtype), as a Python
        # float: no host-to-device copy (and no host sync) per forward
        self.emb_scale = float(torch.tensor(cfg.d_model**0.5, dtype=dtype))
        self.kinds = cfg.layer_pattern * cfg.n_periods + cfg.tail_pattern
        self.layers = nn.ModuleList(Block(cfg, kind, dtype, dev) for kind in self.kinds)
        if seed is not None:
            self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def reset_parameters(self, seed: int) -> None:
        """Every parameter from one ``torch.Generator`` on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        layers.normal_(self.embed, gen, 0.02)
        self.final_norm.reset_parameters(gen)
        if hasattr(self, "unembed"):
            layers.dense_(self.unembed, gen)
        for block in self.layers:
            for mod in (block.pre_norm, block.core, getattr(block, "post_norm", None),
                        block.pre_mlp_norm, block.mlp, getattr(block, "post_mlp_norm", None)):
                if mod is not None:
                    mod.reset_parameters(gen)

    # -- caches ---------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> list[attention.KVCache]:
        """One cache per layer (ring caches ``min(window, max_len)`` long on
        ``attn_local`` layers)."""
        return [attention.init_cache(self.cfg, kind, batch, max_len, self.dtype, self.device)
                for kind in self.kinds]

    # -- forward ----------------------------------------------------------------

    def forward_hidden(self, inputs: torch.Tensor, *, mode: str, rope_positions=None,
                       caches=None, t: int | None = None, valid_from=None):
        """inputs: token ids [B, S].  Returns ``(hidden [B, S, d], caches)``."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose {MODES}")
        if mode != "train" and caches is None:
            raise ValueError(f"mode={mode!r} needs caches (init_caches)")
        cfg = self.cfg
        # ids outside [0, V) gather as the reference's gather takes them: a
        # negative id counts from the end, and the result is clamped to the
        # table (no device-side assert on the card)
        V = self.embed.shape[0]
        ids = torch.where(inputs < 0, inputs + V, inputs).clamp(0, V - 1)
        x = self.embed[ids].to(self.dtype)
        if cfg.emb_scale:
            x = x * self.emb_scale
        B, S = x.shape[0], x.shape[1]
        if rope_positions is None:
            base = (torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
                    if mode != "decode" else
                    torch.full((B, 1), t, dtype=torch.int32, device=x.device))
            rope_positions = base.expand(3, B, S) if cfg.rope_kind == "mrope" else \
                base.expand(B, S)
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            x, cache = block(x, cfg, rope_positions, mode, cache, t, valid_from)
            if new_caches is not None:
                new_caches.append(cache)
        return self.final_norm(x), new_caches

    def logits_for(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 logits [B, S, V] with the final softcap: products of the
        working-dtype operands accumulated and returned in fp32, as the
        reference's ``preferred_element_type`` (on the card a bf16 product
        with a float32 output, so the vocabulary matrix is never copied to
        float32)."""
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        flat = hidden.reshape(-1, hidden.shape[-1])
        if flat.dtype != torch.float32 and flat.is_cuda:
            logits = torch.mm(flat, w, out_dtype=torch.float32)
        else:
            logits = flat.float() @ w.float()
        logits = logits.reshape(*hidden.shape[:-1], w.shape[-1])
        return layers.softcap(logits, self.cfg.final_logit_softcap)

    def prefill(self, inputs, caches, valid_from=None):
        """Last-position logits [B, 1, V] and the filled caches."""
        hidden, caches = self.forward_hidden(inputs, mode="prefill", caches=caches,
                                             valid_from=valid_from)
        return self.logits_for(hidden[:, -1:, :]), caches

    def decode_step(self, inputs, t: int, caches):
        """inputs [B, 1] token ids at absolute position ``t`` → logits [B, 1, V]."""
        hidden, caches = self.forward_hidden(inputs, mode="decode", caches=caches, t=t)
        return self.logits_for(hidden), caches
