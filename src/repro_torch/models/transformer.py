"""The decoder stack: train / prefill / decode for every assigned arch.

The port of the reference's ``repro.models.transformer``: attention layers
(``attn``, ``attn_local``, ``attn_global``), Griffin recurrent layers
(``rec``, ``repro_torch.models.griffin``), Mamba-2 SSD layers (``ssd``,
``repro_torch.models.ssm``), dense or mixture-of-experts FFNs
(``repro_torch.models.moe``), token ids or precomputed embeddings
(``input_mode == "embeds"``: a ``[B, S, d]`` input is cast to the model's
dtype, with no gather and no ``emb_scale``; ids ``[B, S]`` still gather).
Layers are a flat ``ModuleList`` in ``layer_pattern`` order (period after
period, then ``tail_pattern``), not the reference's scanned super-blocks;
``repro_torch.interop.params_from_jax`` maps the reference's stacked tree
onto it.

Modes of :meth:`Decoder.forward_hidden`:
  * train   — full sequence, no caches; under autograd each layer is
    recomputed in the backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint`` with ``nothing_saveable``), so only the layers'
    inputs are kept;
  * prefill — full sequence, fills the per-layer caches;
  * decode  — one token against the caches at absolute position ``t``
    (MoE at exact capacity: no drops).

The full-sequence attention runs through K7
(``repro_torch.kernels.flash_attention``; its plain version for CPU
tensors), its gradient through K7b; the recurrences, the SSD chunks and
the expert products are plain torch, as the reference computes them
outside any Pallas kernel.  ``lm_loss`` and ``train_loss_fn`` are the
reference's losses.
Parameters are created on ``device`` (CUDA unless the caller says
``"cpu"``) and filled from ``seed`` with ``ParamBuilder``'s scales and the
reference's formulas for its value leaves (Griffin's ``lam``, SSD's
``A_log``, ``D``, ``dt_bias``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.partition import even, replicate_plain
from repro_torch.models import attention, griffin, layers, moe, ssm
from repro_torch.models.config import ModelConfig

MODES = ("train", "prefill", "decode")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Block(nn.Module):
    """One layer, as the reference's ``_init_block``: ``pre_norm``, ``core``
    (attention, a Griffin :class:`~repro_torch.models.griffin.Recurrent`
    for ``rec`` or a Mamba-2 :class:`~repro_torch.models.ssm.SSD` for
    ``ssd``), ``post_norm``; then, except in an ``ssd`` block,
    ``pre_mlp_norm``, the FFN (``moe``, plus ``mlp`` with
    ``dense_residual``, when ``cfg.moe``; else ``mlp``) and
    ``post_mlp_norm`` (the post-norms with ``cfg.post_norm``)."""

    def __init__(self, cfg: ModelConfig, kind: str, dtype, device=None):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        self.pre_norm = layers.RMSNorm(d, device)
        if kind.startswith("attn"):
            self.core = attention.Attention(cfg, dtype, device)
        elif kind == "rec":
            self.core = griffin.Recurrent(cfg, dtype, device)
        elif kind == "ssd":
            self.core = ssm.SSD(cfg, dtype, device)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if cfg.post_norm:
            self.post_norm = layers.RMSNorm(d, device)
        if kind != "ssd":  # mamba2 blocks have no FFN sub-layer
            self.pre_mlp_norm = layers.RMSNorm(d, device)
            if cfg.moe is not None:
                self.moe = moe.MoE(cfg, dtype, device)
            if cfg.moe is None or cfg.moe.dense_residual:
                self.mlp = layers.MLP(d, cfg.d_ff, cfg.mlp_kind, dtype, device)
            if cfg.post_norm:
                self.post_mlp_norm = layers.RMSNorm(d, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(gen)

    def _core(self, h, cfg: ModelConfig, rope_pos, mode: str, cache, t, valid_from, shard):
        if self.kind.startswith("attn"):
            if mode == "train":
                return attention.attn_full(self.core, h, cfg, self.kind, rope_pos, shard), None
            if mode == "prefill":
                return attention.attn_prefill(self.core, h, cfg, self.kind, rope_pos, cache,
                                              valid_from, shard)
            return attention.attn_decode(self.core, h, cfg, self.kind, rope_pos, cache, t)
        full, decode = ((griffin.rec_block_full, griffin.rec_block_decode)
                        if self.kind == "rec" else (ssm.ssd_block_full, ssm.ssd_block_decode))
        if mode == "decode":
            return decode(self.core, h, cfg, cache)
        y, cache = full(self.core, h, cfg)
        return y, (cache if mode == "prefill" else None)

    def forward(self, x, cfg: ModelConfig, rope_pos, mode: str, cache, t, valid_from,
                count_drops: bool = True, shard=None):
        """Returns ``(x, cache, aux)``; ``aux`` is the MoE load-balance term
        (None without MoE).  ``count_drops=False`` leaves ``MoE.dropped``
        alone (the backward's recompute of a train step).  ``shard``: the
        partitioner (or None), for the attention's and the MoE's sharded
        paths."""
        y, cache = self._core(self.pre_norm(x), cfg, rope_pos, mode, cache, t, valid_from,
                              shard)
        if cfg.post_norm:
            y = self.post_norm(y)
        x = x + y
        aux = None
        if self.kind == "ssd":
            return x, cache, aux
        h = self.pre_mlp_norm(x)
        if cfg.moe is not None:
            # no capacity drops for single-token decode, as the reference
            y, aux = self.moe(h, cfg, exact=mode == "decode", count=count_drops, shard=shard)
            if cfg.moe.dense_residual:
                y = y + self.mlp(h)
        else:
            y = self.mlp(h)
        if cfg.post_norm:
            y = self.post_mlp_norm(y)
        return x + y, cache, aux


class Decoder(nn.Module):
    """``embed`` [V, d], ``final_norm``, ``unembed`` [d, V] (untied only) and
    ``layers`` — one :class:`Block` per layer."""

    AXES = {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab")}

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int | None = 0):
        super().__init__()
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
            block.reset_parameters(gen)

    def param_axes(self) -> dict:
        """The logical axes of every parameter, by name (the order of
        ``named_parameters``): the reference's ``split_params`` axes of the
        same leaf, without the leading ``layers`` entry of its
        period-stacked leaves (each layer is a module of its own here)."""
        axes = {}
        for prefix, mod in self.named_modules():
            for name, _ in mod.named_parameters(recurse=False):
                axes[f"{prefix}.{name}" if prefix else name] = type(mod).AXES[name]
        return {name: axes[name] for name, _ in self.named_parameters()}

    def moe_layers(self) -> list:
        """The MoE modules, layer by layer (empty without ``cfg.moe``)."""
        return [block.moe for block in self.layers if hasattr(block, "moe")]

    # -- caches ---------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int) -> list:
        """One cache per layer, of its kind: a ``KVCache`` (ring caches
        ``min(window, max_len)`` long on ``attn_local`` layers), a
        ``RecCache`` or an ``SSMCache``."""
        out = []
        for kind in self.kinds:
            if kind == "rec":
                out.append(griffin.init_rec_cache(self.cfg, batch, self.dtype, self.device))
            elif kind == "ssd":
                out.append(ssm.init_ssm_cache(self.cfg, batch, self.dtype, self.device))
            else:
                out.append(attention.init_cache(self.cfg, kind, batch, max_len, self.dtype,
                                                self.device))
        return out

    # -- forward ----------------------------------------------------------------

    def forward_hidden(self, inputs: torch.Tensor, *, mode: str, rope_positions=None,
                       caches=None, t: int | None = None, valid_from=None,
                       remat: bool = True, shard=None):
        """inputs: token ids [B, S], or embeddings [B, S, d] for an ``embeds``
        config.  Returns ``(hidden [B, S, d], caches, aux)``, ``aux`` the
        summed MoE load-balance term (float32 0-dim; 0 without MoE).  In
        train mode under autograd, with ``remat``, each layer runs inside
        ``torch.utils.checkpoint`` (non-reentrant): its activations are
        recomputed in the backward, and its MoE drops are counted in the
        first run only.

        ``shard``: a :class:`~repro_torch.dist.partition.Partitioner` over a
        mesh, for a model whose parameters it placed (``train.step.shard_model``):
        the forward then runs on DTensors, with the reference's activation
        constraints (the embedding's output and each period's output on
        the batch axes, the logits' vocabulary on ``model``), K7 and K7b
        on each rank's local heads or query rows, and the expert-parallel
        MoE; plain tensors it meets (ids, positions, masks) count as
        replicated."""
        with shard_context(shard):
            return self._forward_hidden(inputs, mode, rope_positions, caches, t, valid_from,
                                        remat, active_shard(shard))

    def _forward_hidden(self, inputs, mode, rope_positions, caches, t, valid_from, remat,
                        shard):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose {MODES}")
        if mode != "train" and caches is None:
            raise ValueError(f"mode={mode!r} needs caches (init_caches)")
        cfg = self.cfg
        # ids outside [0, V) gather as the reference's gather takes them: a
        # negative id counts from the end, and the result is clamped to the
        # table (no device-side assert on the card)
        if cfg.input_mode == "embeds" and inputs.dim() == 3:
            x = inputs.to(self.dtype)
        else:
            V = self.embed.shape[0]
            ids = torch.where(inputs < 0, inputs + V, inputs).clamp(0, V - 1)
            x = self.embed[ids].to(self.dtype)
            if cfg.emb_scale:
                x = x * self.emb_scale
        if shard is not None:
            x = shard(x, "batch", None, None)
        B, S = x.shape[0], x.shape[1]
        if rope_positions is None:
            base = (torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
                    if mode != "decode" else
                    torch.full((B, 1), t, dtype=torch.int32, device=x.device))
            rope_positions = base.expand(3, B, S) if cfg.rope_kind == "mrope" else \
                base.expand(B, S)
        new_caches = [] if caches is not None else None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if shard is not None:
            aux = shard.as_dtensor(aux)
        remat = remat and mode == "train" and torch.is_grad_enabled()
        P = len(cfg.layer_pattern)
        for i, block in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            if remat:
                x, a = checkpoint(_train_block, block, x, cfg, rope_positions, [True], shard,
                                  use_reentrant=False)
            else:
                x, cache, a = block(x, cfg, rope_positions, mode, cache, t, valid_from,
                                    shard=shard)
            if shard is not None and i % P == P - 1 and i < P * cfg.n_periods:
                x = shard(x, "batch", None, None)  # the end of a period (super-block)
            if a is not None:
                aux = aux + a
            if new_caches is not None:
                new_caches.append(cache)
        return self.final_norm(x), new_caches, aux

    def logits_for(self, hidden: torch.Tensor, shard=None) -> torch.Tensor:
        """fp32 logits [B, S, V] with the final softcap: products of the
        working-dtype operands accumulated and returned in fp32, as the
        reference's ``preferred_element_type`` (on the card a bf16 product
        with a float32 output, so the vocabulary matrix is never copied to
        float32).  ``shard``: the vocabulary dim placed on ``model``."""
        w = self.embed.T if self.cfg.tie_embeddings else self.unembed
        flat = even(hidden).reshape(-1, hidden.shape[-1])
        if flat.dtype != torch.float32 and flat.is_cuda:
            logits = layers.mm_f32(flat, w)
        else:
            logits = flat.float() @ w.float()
        logits = logits.reshape(*hidden.shape[:-1], w.shape[-1])
        logits = layers.softcap(logits, self.cfg.final_logit_softcap)
        if shard is not None:
            logits = shard(logits, "batch", None, "vocab")
        return logits

    def stacks(self) -> dict:
        """The reference's period-stacked leaves: ``"layers/block{b}/<path>"``
        → the names of that parameter in layers ``b, b + P, b + 2P, ...``
        (P = the pattern's period), over the ``n_periods`` whole periods;
        the tail's layers and the top-level parameters are leaves of their
        own.  The Adafactor update spans each such leaf, as the reference's."""
        P = len(self.cfg.layer_pattern)
        out: dict = {}
        for name, _ in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "layers" and int(parts[1]) < P * self.cfg.n_periods:
                key = f"layers/block{int(parts[1]) % P}/" + "/".join(parts[2:])
                out.setdefault(key, []).append(name)
        return out

    def trainable(self) -> dict:
        """The parameters by name, each set to require grad (the train
        state's ``params``: the module's own tensors, not copies)."""
        params = dict(self.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        return params

    def prefill(self, inputs, caches, valid_from=None, rope_positions=None, shard=None):
        """inputs: token ids [B, S] or embeddings [B, S, d] → last-position
        logits [B, 1, V] and the filled caches."""
        hidden, caches, _ = self.forward_hidden(inputs, mode="prefill", caches=caches,
                                                valid_from=valid_from,
                                                rope_positions=rope_positions, shard=shard)
        with shard_context(shard):
            return self.logits_for(hidden[:, -1:, :], active_shard(shard)), caches

    def decode_step(self, inputs, t: int, caches, rope_positions=None, shard=None):
        """inputs: token ids [B, 1] or embeddings [B, 1, d] at absolute
        position ``t`` → logits [B, 1, V] and the caches."""
        hidden, caches, _ = self.forward_hidden(inputs, mode="decode", caches=caches, t=t,
                                                rope_positions=rope_positions, shard=shard)
        with shard_context(shard):
            return self.logits_for(hidden, active_shard(shard)), caches


def _layer_cache_axes(kind: str):
    """Logical axes of one layer's cache, leaf for leaf (the reference's
    ``_layer_cache_axes``): the KV cache's sequence dim stays whole
    (``seq_kv``), its KV heads on ``model`` where they divide."""
    if kind == "rec":
        return griffin.RecCache(conv=("batch", "conv", "lru"), h=("batch", "lru"))
    if kind == "ssd":
        return ssm.SSMCache(conv=("batch", "conv", "inner"), h=("batch", "heads", None, None))
    return attention.KVCache(k=("batch", "seq_kv", "kv", "head_dim"),
                             v=("batch", "seq_kv", "kv", "head_dim"), pos=("batch", None))


def cache_axes(cfg: ModelConfig) -> list:
    """Logical-axes tree matching ``Decoder.init_caches``: one cache per
    layer (the reference's stacked caches without their ``layers`` entry)."""
    return [_layer_cache_axes(kind)
            for kind in cfg.layer_pattern * cfg.n_periods + cfg.tail_pattern]


def active_shard(shard):
    """The partitioner when it has a mesh, else None (the reference's
    ``shard = partitioner if partitioner and partitioner.mesh``)."""
    return shard if shard is not None and shard.mesh is not None else None


def shard_context(shard):
    """The context a partitioned forward runs in: plain tensors meeting
    DTensors count as replicated (``replicate_plain``)."""
    return replicate_plain() if active_shard(shard) is not None else contextlib.nullcontext()


def _train_block(block: Block, x, cfg: ModelConfig, rope_pos, first: list, shard=None):
    """One train-mode layer inside ``torch.utils.checkpoint``: ``first``
    holds True for the forward's run and False once it ran, so the
    backward's recompute does not count the layer's MoE drops again (the
    recompute runs in the backward, so it enters the partitioned context
    itself)."""
    count, first[0] = first[0], False
    with shard_context(shard):
        x, _, aux = block(x, cfg, rope_pos, "train", None, None, None, count_drops=count,
                          shard=shard)
    return x, aux


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _chunk_nll(model: Decoder, hidden: torch.Tensor, labels: torch.Tensor,
               shard=None) -> torch.Tensor:
    """Summed negative log-likelihood of one chunk: fp32 logits (with the
    final softcap), log-sum-exp minus the gold logit."""
    with shard_context(shard):
        logits = model.logits_for(hidden, shard)
        if shard is None:
            gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        else:  # the gold logit picked on each vocabulary shard and summed
            vocab = torch.arange(logits.shape[-1], device=labels.device)
            gold = torch.where(vocab == labels.long()[..., None], logits, 0.0).sum(-1)
        return (torch.logsumexp(logits, -1) - gold).sum()


def lm_loss(model: Decoder, hidden: torch.Tensor, labels: torch.Tensor, *,
            seq_chunk: int = 512, shard=None) -> torch.Tensor:
    """The reference's ``lm_loss``: cross-entropy over the sequence in
    chunks of ``min(seq_chunk, S)`` positions, the remainder unchunked,
    summed in float32 and divided by ``B·S``, so ``[B, S, V]`` logits are
    never whole.  Under autograd each chunk is recomputed in the backward
    (``torch.utils.checkpoint``): one chunk's logits live at a time."""
    B, S, _ = hidden.shape
    chunk = min(seq_chunk, S)
    bounds = [(lo, lo + chunk) for lo in range(0, S - S % chunk, chunk)]
    if S % chunk:
        bounds.append((S - S % chunk, S))
    remat = torch.is_grad_enabled() and hidden.requires_grad
    shard = active_shard(shard)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    with shard_context(shard):
        for lo, hi in bounds:
            h, y = hidden[:, lo:hi], labels[:, lo:hi]
            nll = (checkpoint(_chunk_nll, model, h, y, shard, use_reentrant=False) if remat
                   else _chunk_nll(model, h, y, shard))
            total = total + nll
        return total / (B * S)


def train_loss_fn(model: Decoder, batch: dict, aux_weight: float = 0.01, shard=None):
    """The reference's ``train_loss_fn``: the train-mode forward of
    ``batch["inputs"]`` (token ids, or embeddings for an ``embeds`` config;
    ``batch["positions"]`` for M-RoPE), :func:`lm_loss` against
    ``batch["labels"]`` plus ``aux_weight`` times the summed MoE
    load-balance term.  Returns ``(loss, {"xent", "moe_aux"})``."""
    hidden, _, aux = model.forward_hidden(batch["inputs"], mode="train",
                                          rope_positions=batch.get("positions"), shard=shard)
    loss = lm_loss(model, hidden, batch["labels"], shard=shard)
    with shard_context(shard):
        if active_shard(shard) is not None:  # the sums of the shards' parts, on every rank
            loss, aux = (shard.replicate(t) for t in (loss, aux))
        return loss + aux_weight * aux, {"xent": loss, "moe_aux": aux}
