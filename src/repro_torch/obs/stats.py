"""The counting half of the reference's ``obs/metrics.py`` stats base."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StatsBase:
    """The schedule census every stats ledger carries.

    ``reduce_rounds`` counts collective rounds by resolved reduce
    implementation; ``auto_hop_bytes`` and ``hop_calibrated`` record the
    wire-model calibration the ``auto`` resolver used.
    """

    reduce_rounds: dict = field(default_factory=dict)
    auto_hop_bytes: int = 0
    hop_calibrated: bool = False

    def record_reduce(self, impl: str, n: int = 1) -> None:
        self.reduce_rounds[impl] = self.reduce_rounds.get(impl, 0) + n
