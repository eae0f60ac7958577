"""arctic-480b [moe] — 128 experts top-2 with a dense residual FFN in
parallel (dense-MoE hybrid) [hf:Snowflake/snowflake-arctic-base]."""

from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # dense residual branch
    vocab_size=32_000,
    head_dim=128,
    rope_kind="standard",
    rope_theta=10_000.0,
    mlp_kind="swiglu",
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
    ),
)
