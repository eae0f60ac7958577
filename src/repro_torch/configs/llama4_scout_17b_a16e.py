"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Multimodal early
fusion is frontend-side and stubbed per assignment rules (text tokens)."""

from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    head_dim=128,
    rope_kind="standard",
    rope_theta=500_000.0,
    mlp_kind="swiglu",
    moe=MoEConfig(
        n_experts=16,
        top_k=1,
        d_ff_expert=8192,
        shared_expert=True,
    ),
)
