"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified].  O(1)-state decode → long_500k eligible."""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,  # d_inner / head_dim = 2048/64 (bookkeeping only; attn-free)
    n_kv_heads=1,
    d_ff=0,  # no FFN sub-layer in mamba2 blocks
    vocab_size=50_280,
    rope_kind="none",
    layer_pattern=("ssd",),
    ssm=SSMConfig(state_size=128, conv_width=4, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
    subquadratic=True,
)
