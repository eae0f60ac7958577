"""Model / shape configuration dataclasses for the assigned archs.

A copy of the reference's ``repro.models.config`` (pure Python): every
architecture is a ``ModelConfig``; heterogeneous layer stacks (gemma2
local/global alternation, griffin's rec-rec-attn pattern) are a repeating
``layer_pattern`` of ``period`` layers, with any non-divisible tail in
``tail_pattern``.  The port's decoder runs its layers as a flat
``ModuleList`` in that order.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual: bool = False  # arctic: dense FFN residual ∥ MoE
    shared_expert: bool = False  # llama4: always-on shared expert
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 128
    conv_width: int = 4
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class GriffinConfig:
    lru_width: int | None = None  # defaults to d_model
    conv_width: int = 4
    attn_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # Attention flavour.
    rope_kind: str = "standard"  # none | standard | mrope
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    attn_window: int | None = None  # for *_local layers
    layer_pattern: tuple[str, ...] = ("attn",)  # attn|attn_local|attn_global|rec|ssd
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    qkv_bias: bool = False
    # FFN / norms.
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    post_norm: bool = False  # gemma2: post-attn/post-ffn norms
    emb_scale: bool = False  # gemma: embeddings × sqrt(d_model)
    tie_embeddings: bool = False
    # Sub-configs.
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    griffin: GriffinConfig | None = None
    # Modality stubs (vlm/audio): the backbone consumes precomputed
    # frame/patch embeddings instead of token ids (assignment rules).
    input_mode: str = "tokens"  # tokens | embeds
    # Sub-quadratic decode: eligible for the long_500k shape.
    subquadratic: bool = False
    dtype: str = "bfloat16"

    # -- derived ------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def tail_pattern(self) -> tuple[str, ...]:
        """Layers left over when n_layers % period != 0 (unrolled)."""
        return self.layer_pattern[: self.n_layers % self.period]

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        gated = self.mlp_kind in ("swiglu", "geglu")
        mlp_dense = d * self.d_ff * (3 if gated else 2)
        total = 0
        for kind in self.layer_pattern * self.n_periods + self.tail_pattern:
            if kind.startswith("attn"):
                total += attn + mlp_dense
            elif kind == "rec":
                g = self.griffin
                w = g.lru_width or d
                total += 2 * d * w + w * d + w * g.conv_width + 3 * w + mlp_dense
            elif kind == "ssd":
                s = self.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.state_size
                total += (
                    d * (2 * d_in + 2 * s.n_groups * s.state_size + nh)
                    + conv_dim * s.conv_width
                    + d_in * d
                )
        if self.moe is not None:
            e = self.moe
            moe_mlp = e.n_experts * d * e.d_ff_expert * 3 + d * e.n_experts
            if e.shared_expert:
                moe_mlp += d * e.d_ff_expert * 3
            per_layer_dense = mlp_dense if self.moe.dense_residual else 0
            # replace the dense MLP accounted above with MoE (+ optional dense)
            total += self.n_layers * (moe_mlp + per_layer_dense - mlp_dense)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        full = self.param_count()
        inactive_experts = e.n_experts - e.top_k
        return full - self.n_layers * inactive_experts * self.d_model * e.d_ff_expert * 3

    # -- reduced config for CPU smoke tests ----------------------------------

    def reduced(self) -> "ModelConfig":
        """Same family/pattern, tiny dims — runs a real step on CPU."""
        changes: dict = dict(
            # 2 full periods + the original tail remainder, so the smoke
            # test exercises both the scanned and unrolled paths.
            n_layers=2 * self.period + (self.n_layers % self.period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            dtype="float32",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_size=16, head_dim=16, chunk_size=32
            )
        if self.griffin is not None:
            changes["griffin"] = dataclasses.replace(
                self.griffin, lru_width=64, attn_window=32
            )
        if self.attn_window is not None:
            changes["attn_window"] = 32
        if self.rope_kind == "mrope":
            changes["mrope_sections"] = (2, 3, 3)  # sums to head_dim/2 = 8
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (skip, see DESIGN.md)"
    return True, ""
