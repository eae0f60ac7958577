"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec
[arXiv:2402.19427].  Sub-quadratic → eligible for long_500k."""

from repro_torch.models.config import GriffinConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,  # 8 × (rec, rec, attn_local) + (rec, rec) tail
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,  # MQA
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    rope_kind="standard",
    rope_theta=10_000.0,
    layer_pattern=("rec", "rec", "attn_local"),
    griffin=GriffinConfig(lru_width=2560, conv_width=4, attn_window=2048),
    mlp_kind="geglu",
    emb_scale=True,
    tie_embeddings=True,
    subquadratic=True,
)
