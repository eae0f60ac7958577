"""RuleIndex — the extracted bases as a device-resident serving artifact.

The combined rule table (DG implications, confidence ≡ 1, followed by the
Luxenburger partial rules) padded to a power-of-two cap and replicated
through the plan, so :class:`repro_torch.query.engine.QueryEngine`'s
fixed-slot rule ops read it like any other snapshot table — zero
collective rounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.device import resolve_device
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.kernels.ops import bucket_size
from repro_torch.rules.basis import RuleBasis, RuleSet


@dataclasses.dataclass(frozen=True)
class RuleIndex:
    n_rules: int
    n_exact: int  # leading rows that are DG implications (conf ≡ 1)
    cap: int
    premise: torch.Tensor  # [cap, W] int32 (pads all-ones: match nothing real)
    added: torch.Tensor  # [cap, W] int32
    support: torch.Tensor  # [cap] int32
    confidence: torch.Tensor  # [cap] float32 (pads -1)
    lift: torch.Tensor  # [cap] float32 (pads -1)
    # canonical rule identity, the deterministic tie-break key for ranked
    # queries: position in the combined basis (implications first, then the
    # Luxenburger rules in canonical order).  Pads get INT32_MAX so a pad
    # can never win a tie against a real rule.
    rule_id: torch.Tensor  # [cap] int32
    # host copies (oracles, answer detail expansion)
    premise_np: np.ndarray
    added_np: np.ndarray
    support_np: np.ndarray
    confidence_np: np.ndarray
    lift_np: np.ndarray

    @classmethod
    def build(cls, basis: RuleBasis, *, plan: ShardPlan | None = None,
              device=None) -> "RuleIndex":
        """The index of ``basis`` on ``device`` (CUDA unless the caller
        says so; a process-group plan fixes it)."""
        plan = plan or ShardPlan.simulated(1)
        device = plan.device if plan.device is not None else resolve_device(device)
        combined: RuleSet = basis.combined()
        R = len(combined)
        W = combined.premise.shape[1]
        cap = bucket_size(max(1, R), minimum=8)
        prem = np.full((cap, W), 0xFFFFFFFF, np.uint32)
        added = np.zeros((cap, W), np.uint32)
        sup = np.zeros((cap,), np.int32)
        conf = np.full((cap,), -1.0, np.float32)
        lift = np.full((cap,), -1.0, np.float32)
        prem[:R] = combined.premise
        added[:R] = combined.added
        sup[:R] = combined.support
        conf[:R] = combined.confidence
        lift[:R] = combined.lift
        rid = np.full((cap,), np.iinfo(np.int32).max, np.int32)
        rid[:R] = np.arange(R, dtype=np.int32)

        def place(a):
            return plan.replicate(a, device)

        return cls(
            n_rules=R,
            n_exact=basis.n_implications,
            cap=cap,
            premise=place(prem),
            added=place(added),
            support=place(sup),
            confidence=place(conf),
            lift=place(lift),
            rule_id=place(rid),
            premise_np=prem[:R],
            added_np=added[:R],
            support_np=sup[:R],
            confidence_np=conf[:R],
            lift_np=lift[:R],
        )

    def describe(self) -> dict:
        return {
            "rules": self.n_rules,
            "exact": self.n_exact,
            "partial": self.n_rules - self.n_exact,
            "cap": self.cap,
        }


def rule_query_mix(
    ctx,
    index: RuleIndex,
    n: int,
    rng,
    *,
    thin: float = 0.3,
    hit_fraction: float = 0.5,
) -> np.ndarray:
    """The standard rule-serving traffic mix (the CLI's and chip_smoke's):
    context rows thinned to ``thin`` bit density (mixed hit/miss traffic),
    with the leading ``hit_fraction`` of the batch overwritten by real rule
    premises (guaranteed hits)."""
    base = ctx.rows[rng.integers(0, ctx.n_objects, size=n)]
    keep = bitset.pack_bool(rng.random((n, ctx.n_attrs)) < thin, ctx.W)
    queries = base & keep
    if index.n_rules:
        n_hit = int(n * hit_fraction)
        picks = rng.integers(0, index.n_rules, size=n_hit)
        queries[:n_hit] = index.premise_np[picks]
    return queries
