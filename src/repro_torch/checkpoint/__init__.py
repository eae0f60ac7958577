"""Checkpoints of the port's train state (``repro_torch.checkpoint.ckpt``)."""

from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    flatten,
    have_zstd,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "flatten",
    "have_zstd",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
