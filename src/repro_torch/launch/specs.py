"""Abstract input specs for every cell: tensors that hold no memory.

The counterpart of the reference's ``repro.launch.specs``: the same
inputs, shapes and dtypes (token ids int32, or embeddings in the model's
dtype; next-token labels; M-RoPE positions ``[3, B, S]``; a decode's one
token per slot, its position ``t`` and the caches at ``S``), as meta
tensors — or, under the caller's ``FakeTensorMode``, fake tensors on
``device`` (the dry-run traces the real step against these).  The caches
are the port's per-layer list (``Decoder.init_caches``'s layout,
``transformer.init_caches``), where the reference stacks each period's.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, ShapeConfig


def _t(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _inputs(cfg: ModelConfig, B: int, S: int, device) -> torch.Tensor:
    if cfg.input_mode == "embeds":
        return _t((B, S, cfg.d_model), transformer.DTYPES[cfg.dtype], device)
    return _t((B, S), torch.int32, device)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """Training batch: tokens (or stub embeddings) + next-token labels."""
    B, S = shape.global_batch, shape.seq_len
    out = {"inputs": _inputs(cfg, B, S, device), "labels": _t((B, S), torch.int32, device)}
    if cfg.rope_kind == "mrope":
        out["positions"] = _t((3, B, S), torch.int32, device)
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """One-step decode: single token per slot + KV/state caches at S_max."""
    B, S = shape.global_batch, shape.seq_len
    out = {"inputs": _inputs(cfg, B, 1, device), "t": _t((), torch.int32, device),
           "caches": transformer.init_caches(cfg, B, S, device=device)}
    if cfg.rope_kind == "mrope":
        out["positions"] = _t((3, B, 1), torch.int32, device)
    return out


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    B, S = shape.global_batch, shape.seq_len
    out = {"inputs": _inputs(cfg, B, S, device),
           "caches": transformer.init_caches(cfg, B, S, device=device)}
    if cfg.rope_kind == "mrope":
        out["positions"] = _t((3, B, S), torch.int32, device)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig, device="meta") -> dict:
    """Dispatch on the shape's kind (train | prefill | decode)."""
    if shape.kind == "train":
        return batch_specs(cfg, shape, device)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, device)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape, device)
    raise ValueError(shape.kind)
