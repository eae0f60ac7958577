"""LM data pipeline: deterministic synthetic token streams (numpy only).

A copy of the reference's ``repro.data.lm_data``: a Zipf-weighted Markov
chain over the vocabulary, seeded per step so that a batch is a pure
function of ``(seed, step)``, with next-token labels.  For
``input_mode == "embeds"`` configs (qwen2-vl, musicgen) the inputs are the
reference's modality stub, seeded standard-normal frame/patch embeddings
``[B, S, d]`` (float32); for M-RoPE configs the batch carries the three
position streams ``[3, B, S]``, all ``arange(S)`` as for text.  Batches
are numpy arrays; the caller moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 32  # Markov successors per state


class SyntheticLM:
    """Deterministic, seekable synthetic corpus."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # each token has `branching` plausible successors with Zipf weights
        self._succ = rng.integers(0, V, size=(V, cfg.branching), dtype=np.int32)
        w = 1.0 / np.arange(1, cfg.branching + 1)
        self._w = w / w.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Batch for a given step — a pure function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=B)
        choices = rng.choice(cfg.branching, size=(B, S), p=self._w)
        for t in range(S):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(model_cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                        start_step: int = 0):
    """Step-indexed iterator of ``(step, batch)``, resumable from any step."""
    data = SyntheticLM(
        LMDataConfig(
            vocab_size=model_cfg.vocab_size,
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            seed=seed,
        )
    )
    step = start_step
    while True:
        b = data.batch(step)
        if model_cfg.input_mode == "embeds":
            # modality stub: deterministic embeddings in place of token ids
            rng = np.random.default_rng((seed, step, 1))
            b["inputs"] = rng.standard_normal(
                (shape.global_batch, shape.seq_len, model_cfg.d_model)
            ).astype(np.float32)
        if model_cfg.rope_kind == "mrope":
            pos = np.broadcast_to(
                np.arange(shape.seq_len, dtype=np.int32),
                (3, shape.global_batch, shape.seq_len),
            )
            b["positions"] = np.ascontiguousarray(pos)
        yield step, b
        step += 1
