"""Config registry of the port: the reference's 10 architectures, copied.

``get_config(name)`` returns the full-size ModelConfig; ``--arch`` ids use
the assignment spelling (dots/dashes), module names use underscores.
``ArchPlan`` carries the reference's per-arch deployment choices (FSDP,
optimizer), kept as data; no module of the port reads them yet.  The
port's decoder (``repro_torch.models.transformer``) runs every arch.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_ARCH_MODULES = {
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma2-9b": "gemma2_9b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "arctic-480b": "arctic_480b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "musicgen-large": "musicgen_large",
    "mamba2-370m": "mamba2_370m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ArchPlan:
    """Deployment plan: how this arch is sharded/optimized at scale."""

    fsdp: bool  # shard params' d_model dims over 'data' (ZeRO-3 style)
    optimizer: str  # adamw | adafactor


# The reference's plans: FSDP + a factored optimizer for the largest models.
_PLANS = {
    "codeqwen1.5-7b": ArchPlan(fsdp=False, optimizer="adamw"),
    "starcoder2-7b": ArchPlan(fsdp=False, optimizer="adamw"),
    "gemma2-9b": ArchPlan(fsdp=False, optimizer="adamw"),
    "deepseek-coder-33b": ArchPlan(fsdp=True, optimizer="adamw"),
    "qwen2-vl-72b": ArchPlan(fsdp=True, optimizer="adafactor"),
    "recurrentgemma-2b": ArchPlan(fsdp=False, optimizer="adamw"),
    "arctic-480b": ArchPlan(fsdp=True, optimizer="adafactor"),
    "llama4-scout-17b-a16e": ArchPlan(fsdp=True, optimizer="adamw"),
    "musicgen-large": ArchPlan(fsdp=False, optimizer="adamw"),
    "mamba2-370m": ArchPlan(fsdp=False, optimizer="adamw"),
}


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_plan(name: str) -> ArchPlan:
    return _PLANS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    """Every (arch, shape) cell with its applicability verdict."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            out.append((arch, shape.name, ok, why))
    return out


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ArchPlan",
    "all_cells",
    "get_config",
    "get_plan",
    "get_shape",
]
