"""gemma2-9b [dense] — local+global alternating attention, logit softcaps,
GeGLU, post-norms, tied embeddings [arXiv:2408.00118]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256_000,
    head_dim=256,
    rope_kind="standard",
    rope_theta=10_000.0,
    layer_pattern=("attn_local", "attn_global"),
    attn_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_kind="geglu",
    post_norm=True,
    emb_scale=True,
    tie_embeddings=True,
    # NOTE: global layers are full quadratic attention → long_500k skipped
    # (DESIGN.md §Arch-applicability).
    subquadratic=False,
)
