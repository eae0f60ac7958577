"""repro_torch.analysis — static & schedule analysis for the SPMD/serve stack.

Four passes over the mining engines and the serving tier, run by
``python -m repro_torch.analysis`` (``--strict`` is the CI gate):

1. :mod:`repro_torch.analysis.spmd_audit` — runs every cached step
   (frontier variants, their fused-kernel twins, the QueryEngine batch
   steps, the rules/basis device passes) under multiple partition
   geometries with a recorder at the collective seam, and verifies
   collective axis binding, schedule order, the wire-byte census against
   the analytic model, and region hygiene (no host read inside a step).

2. :mod:`repro_torch.analysis.lint` — AST rules: no host syncs in the async
   round loops, no wall-clock reads in clock-injectable serve code, no
   mutable defaults / recompile-in-loop hazards, no bare excepts.

3. :mod:`repro_torch.analysis.locks` + :mod:`repro_torch.analysis.fuzz` —
   static lock-discipline inference over the serve-tier classes, plus a
   deterministic schedule-fuzzing harness that replays seeded
   submit/poll/stage/commit interleavings under a virtual clock and
   checks happens-before invariants on snapshot versions.

:mod:`repro_torch.analysis.inventory` additionally emits the import-graph
dead-code census (``ANALYSIS_inventory_torch.json``).
"""

from repro_torch.analysis.findings import Finding, Report

PASSES = ("spmd", "lint", "locks", "fuzz")


def run_all(passes=PASSES, *, quick: bool = False, root=None) -> Report:
    """Run the selected passes into one :class:`Report`.

    Pass modules import lazily: the linter and lock checker are pure-AST
    and must stay runnable even when the kernels or the serving tier fail
    to import.
    """
    report = Report()
    if "lint" in passes:
        from repro_torch.analysis import lint

        report.extend(lint.run(report, root=root))
    if "locks" in passes:
        from repro_torch.analysis import locks

        report.extend(locks.run(report, root=root))
    if "fuzz" in passes:
        from repro_torch.analysis import fuzz

        report.extend(fuzz.run(report))
    if "spmd" in passes:
        from repro_torch.analysis import spmd_audit

        report.extend(spmd_audit.run(report, quick=quick))
    return report


__all__ = ["Finding", "Report", "PASSES", "run_all"]
