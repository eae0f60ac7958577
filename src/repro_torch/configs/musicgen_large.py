"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

Backbone-only per assignment rules: the EnCodec tokenizer/codebook-interleave
frontend is a stub — ``input_specs()`` provides precomputed frame embeddings
[B, S, d] (sum of per-codebook embeddings + sinusoidal positions); the head
predicts one 2048-way codebook stream.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,  # MHA
    d_ff=8192,
    vocab_size=2048,  # EnCodec codebook size
    rope_kind="none",  # sinusoidal positions live in the stubbed embeddings
    mlp_kind="gelu",
    input_mode="embeds",
)
