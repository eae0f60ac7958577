"""Shared result types for the ``repro_torch.analysis`` passes.

Every pass (SPMD audit, host-sync/recompile lint, lock discipline,
schedule fuzz) reports :class:`Finding` rows into one :class:`Report`;
the CLI gate (``python -m repro_torch.analysis --strict``) exits nonzero iff
any finding of severity ``error`` survives the allowlist.
"""

from __future__ import annotations

import dataclasses
import json

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or informational note) from one pass."""

    pass_name: str  # "spmd" | "lint" | "locks" | "fuzz"
    rule: str  # stable rule id, e.g. "undeclared-axis", "host-sync"
    location: str  # "path:line" or a step label like "4x1/rsag/kernel/cbo2d"
    message: str
    severity: str = "error"

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def format(self) -> str:
        return f"[{self.pass_name}:{self.rule}] {self.location}: {self.message}"


@dataclasses.dataclass
class Report:
    """Aggregated findings across passes, plus per-pass run metadata
    (counts of artifacts checked — so "0 findings" is distinguishable
    from "pass never ran")."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    checked: dict = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> "Report":
        self.findings.extend(findings)
        return self

    def note_checked(self, pass_name: str, what: str, n: int = 1):
        key = f"{pass_name}.{what}"
        self.checked[key] = self.checked.get(key, 0) + n

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self) -> str:
        return json.dumps(
            {
                "ok": self.ok,
                "checked": dict(sorted(self.checked.items())),
                "findings": [dataclasses.asdict(f) for f in self.findings],
            },
            indent=2,
            sort_keys=False,
        )

    def format(self) -> str:
        lines = [f.format() for f in self.findings]
        n_err = len(self.errors)
        summary = (
            f"{len(self.findings)} finding(s), {n_err} error(s); "
            f"checked: "
            + ", ".join(f"{k}={v}" for k, v in sorted(self.checked.items()))
        )
        return "\n".join(lines + [summary])
