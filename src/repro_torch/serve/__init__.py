"""LM serving of the port: ``ServeEngine`` over the attention-only decoder."""

from repro_torch.serve.engine import ServeConfig, ServeEngine, GenerateStats

__all__ = ["ServeConfig", "ServeEngine", "GenerateStats"]
