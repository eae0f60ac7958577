"""starcoder2-7b [dense] — GQA, RoPE [arXiv:2402.19173]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    rope_kind="standard",
    rope_theta=100_000.0,
    qkv_bias=True,
    mlp_kind="gelu",  # starcoder2 uses a non-gated gelu FFN (4×d)
)
