"""codeqwen1.5-7b [dense] — qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,  # GQA kv=32 == MHA
    d_ff=13440,
    vocab_size=92416,
    head_dim=128,
    rope_kind="standard",
    rope_theta=1_000_000.0,
    qkv_bias=True,  # qwen1.5 uses qkv biases
    mlp_kind="swiglu",
)
