"""SLO objectives, burn rates, and the benchmark-regression gate.

The port's counterpart of the reference's ``obs/slo.py``, pure Python and
the same code.  Two jobs, one module:

* **Serving objectives** — an :class:`SLO` states the latency and shed
  objectives the serving tier promises (by default: 99.5 % of requests
  finish under 250 ms; a shed rate under 1 %).  These are objectives a
  user states, not measurements.  :func:`evaluate` scores one load report
  against it, with the **burn rate** — the observed error rate over the
  error budget ``1 - target`` (1.0 = exactly consuming the budget; >> 1
  is the alerting signal multiwindow alerts are built on).  ``run_load``
  stamps an evaluation onto its report when given an SLO.

* **Regression gate** — :func:`check_baselines` compares the headline
  metrics of benchmark artifacts (JSON) against a baselines file with a
  tolerance band: latency metrics fail above ``baseline ×
  tolerance_ratio``, rate metrics above ``baseline + rate_slack``, and
  boolean invariants (bit-identity flags) must hold exactly.  ``python -m
  repro_torch.obs.slo --baselines B.json ARTIFACT...`` exits 1 on any
  violation.  The port has no baselines file yet: its baselines are to
  come from runs on the card, and the reference's numbers are not its
  targets.
"""

from __future__ import annotations

import dataclasses
import json
import sys

DEFAULT_TOLERANCE_RATIO = 4.0  # latency: runs on shared hosts are ~this much noisier
DEFAULT_RATE_SLACK = 0.02  # absolute slack for rate metrics (shed fraction)


def get_path(obj, dotted: str):
    """``get_path({"a": {"b": 1}}, "a.b") == 1``; KeyError names the path."""
    cur = obj
    for part in dotted.split("."):
        try:
            cur = cur[part]
        except (KeyError, TypeError):
            raise KeyError(f"no {dotted!r} in artifact (stopped at {part!r})")
    return cur


def burn_rate(compliance: float, target: float) -> float:
    """Error budget consumption rate: ``(1 - compliance) / (1 - target)``.

    1.0 = consuming exactly the budget; below 1 is sustainable; a target
    of 1.0 (zero budget) burns infinitely on any error.
    """
    budget = 1.0 - target
    err = max(0.0, 1.0 - compliance)
    if budget <= 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / budget


@dataclasses.dataclass
class SLO:
    """The serving tier's promises (seconds / fractions)."""

    latency_objective_s: float = 0.25  # e2e objective each request must meet
    latency_target: float = 0.995  # fraction of requests meeting it
    max_shed_rate: float = 0.01  # admission shed fraction
    max_p99_s: float | None = None  # optional hard p99 ceiling

    def describe(self) -> dict:
        return dataclasses.asdict(self)


def evaluate(
    slo: SLO, *, compliance: float, shed_rate: float, p99_s: float | None = None
) -> dict:
    """Score one load measurement against the SLO.

    ``compliance`` is the fraction of requests under
    ``latency_objective_s`` (from ``Histogram.fraction_below``);
    ``shed_rate`` the shed fraction.  Returns objective verdicts plus
    the latency burn rate.
    """
    rate = burn_rate(compliance, slo.latency_target)
    out = {
        "latency_objective_s": slo.latency_objective_s,
        "compliance": round(compliance, 6),
        "latency_target": slo.latency_target,
        "burn_rate": round(rate, 3) if rate != float("inf") else "inf",
        "latency_ok": compliance >= slo.latency_target,
        "shed_rate": round(shed_rate, 6),
        "shed_ok": shed_rate <= slo.max_shed_rate,
    }
    if slo.max_p99_s is not None and p99_s is not None:
        out["p99_s"] = round(p99_s, 6)
        out["p99_ok"] = p99_s <= slo.max_p99_s
    out["ok"] = all(v for k, v in out.items() if k.endswith("_ok"))
    return out


# ---------------------------------------------------------------------------
# bench-regression gate
# ---------------------------------------------------------------------------


def check_baselines(
    artifact: dict,
    baseline: dict,
    *,
    tolerance_ratio: float = DEFAULT_TOLERANCE_RATIO,
    rate_slack: float = DEFAULT_RATE_SLACK,
) -> list[str]:
    """Violations of one artifact against its committed baseline entry.

    ``baseline`` groups dotted metric paths by class::

        {"latency_s": {"headline.e2e.p99": 0.011},   # fail > base × ratio
         "rate":      {"headline.shed_rate": 0.0},   # fail > base + slack
         "exact":     {"headline.bit_identical": true}}  # fail != base

    Returns human-readable violation strings (empty = green).  A missing
    metric path is itself a violation — a gate that silently skips what
    it was told to check is no gate.
    """
    violations = []
    for path, base in baseline.get("latency_s", {}).items():
        try:
            cur = float(get_path(artifact, path))
        except KeyError as e:
            violations.append(str(e))
            continue
        ceiling = float(base) * tolerance_ratio
        if cur > ceiling:
            violations.append(
                f"latency regression: {path} = {cur:.6f}s exceeds baseline "
                f"{base:.6f}s × {tolerance_ratio:g} tolerance "
                f"(ceiling {ceiling:.6f}s)"
            )
    for path, base in baseline.get("rate", {}).items():
        try:
            cur = float(get_path(artifact, path))
        except KeyError as e:
            violations.append(str(e))
            continue
        if cur > float(base) + rate_slack:
            violations.append(
                f"rate regression: {path} = {cur:.6f} exceeds baseline "
                f"{base:.6f} + {rate_slack:g} slack"
            )
    for path, base in baseline.get("exact", {}).items():
        try:
            cur = get_path(artifact, path)
        except KeyError as e:
            violations.append(str(e))
            continue
        if cur != base:
            violations.append(f"invariant broken: {path} = {cur!r} != {base!r}")
    return violations


def run_gate(
    artifact_paths: list[str],
    baselines_path: str,
    *,
    tolerance_ratio: float | None = None,
    rate_slack: float | None = None,
    out=sys.stdout,
) -> int:
    """The gate body: check each artifact against the baselines file.

    The baselines file carries the default tolerances (overridable per
    invocation) and one entry per artifact basename::

        {"tolerance_ratio": 4.0, "rate_slack": 0.02,
         "artifacts": {"BENCH_x.json": {...}, ...}}
    """
    import os

    with open(baselines_path) as f:
        baselines = json.load(f)
    ratio = (
        tolerance_ratio
        if tolerance_ratio is not None
        else baselines.get("tolerance_ratio", DEFAULT_TOLERANCE_RATIO)
    )
    slack = (
        rate_slack
        if rate_slack is not None
        else baselines.get("rate_slack", DEFAULT_RATE_SLACK)
    )
    failures = 0
    for path in artifact_paths:
        name = os.path.basename(path)
        entry = baselines.get("artifacts", {}).get(name)
        if entry is None:
            print(f"FAIL {name}: no baseline entry in {baselines_path}",
                  file=out)
            failures += 1
            continue
        with open(path) as f:
            artifact = json.load(f)
        violations = check_baselines(
            artifact, entry, tolerance_ratio=ratio, rate_slack=slack
        )
        if violations:
            failures += 1
            for v in violations:
                print(f"FAIL {name}: {v}", file=out)
        else:
            checked = sum(
                len(entry.get(k, {})) for k in ("latency_s", "rate", "exact")
            )
            print(
                f"OK   {name}: {checked} metrics within tolerance "
                f"(latency ×{ratio:g}, rate +{slack:g})",
                file=out,
            )
    return 1 if failures else 0


def main(argv=None):
    """``python -m repro_torch.obs.slo --baselines B.json ARTIFACT [ARTIFACT...]``"""
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("artifacts", nargs="+",
                   help="benchmark JSON artifacts to gate")
    p.add_argument("--baselines", required=True,
                   help="baselines file: tolerances and one entry of "
                        "latency_s / rate / exact metric paths per artifact "
                        "basename, taken from runs on the card")
    p.add_argument("--tolerance-ratio", type=float, default=None,
                   help="override the latency tolerance multiplier")
    p.add_argument("--rate-slack", type=float, default=None,
                   help="override the absolute rate slack")
    args = p.parse_args(argv)
    return run_gate(
        args.artifacts,
        args.baselines,
        tolerance_ratio=args.tolerance_ratio,
        rate_slack=args.rate_slack,
    )


if __name__ == "__main__":
    raise SystemExit(main())
