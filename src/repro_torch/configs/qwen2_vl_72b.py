"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

Backbone-only per assignment rules: the vision frontend is a stub —
``input_specs()`` provides precomputed patch/frame embeddings [B, S, d] and
M-RoPE position streams [3, B, S]; for text-only streams the three
positions coincide and M-RoPE degenerates to RoPE.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    rope_kind="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    mlp_kind="swiglu",
    input_mode="embeds",
)
