"""repro_torch.rules — iceberg mining, basis extraction and rule serving.

  * **iceberg mining** — ``min_support`` fused inside the MR* drivers'
    rounds; :func:`mine_iceberg` resolves count-or-fraction thresholds.
  * **basis extraction** (:mod:`repro_torch.rules.basis`) — the
    Duquenne–Guigues implication base and the Luxenburger partial-rule
    base of a store's concept family, with host brute-force oracles.
  * **serving** (:mod:`repro_torch.rules.index` +
    ``QueryEngine.rules_batch``) — the combined basis as a device-resident
    ``RuleIndex`` answered in fixed-slot micro-batches.
"""

from repro_torch.rules.basis import (
    RuleBasis,
    RuleSet,
    dg_basis,
    dg_basis_host,
    extract_bases,
    luxenburger_from_snapshot,
    luxenburger_host,
)
from repro_torch.rules.index import RuleIndex, rule_query_mix
from repro_torch.rules.mining import ALGORITHMS, mine_iceberg, resolve_min_support

__all__ = [
    "ALGORITHMS",
    "RuleBasis",
    "RuleSet",
    "RuleIndex",
    "dg_basis",
    "dg_basis_host",
    "extract_bases",
    "luxenburger_from_snapshot",
    "luxenburger_host",
    "mine_iceberg",
    "resolve_min_support",
    "rule_query_mix",
]
