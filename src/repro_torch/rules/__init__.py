"""Iceberg mining entry points of the port.  Basis extraction and rule
serving come with the rules slice."""

from repro_torch.rules.mining import ALGORITHMS, mine_iceberg, resolve_min_support

__all__ = ["ALGORITHMS", "mine_iceberg", "resolve_min_support"]
