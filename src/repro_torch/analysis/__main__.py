"""CLI: ``python -m repro_torch.analysis [--strict] [--json] [--pass NAME]...``

Exit status: 0 when no error-severity findings survive (or without
``--strict``, always 0 unless a pass crashes); 1 when ``--strict`` and
errors remain.  ``--inventory [PATH]`` writes the import-graph dead-code
census (defaults to ``ANALYSIS_inventory_torch.json`` at the repo root)
and prints its summary.  The SPMD pass runs on the card when one is
present, else on the CPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

# static imports (not just run_all's lazy ones) so the import-graph
# inventory sees every pass module as reachable from this entry point
from repro_torch.analysis import PASSES, run_all
from repro_torch.analysis import findings as _findings  # noqa: F401
from repro_torch.analysis import fuzz as _fuzz  # noqa: F401
from repro_torch.analysis import inventory as inventory_mod
from repro_torch.analysis import lint as _lint  # noqa: F401
from repro_torch.analysis import locks as _locks  # noqa: F401
from repro_torch.analysis import spmd_audit as _spmd  # noqa: F401


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="SPMD auditor, serve-tier linter, and lock checker",
    )
    ap.add_argument(
        "--pass", dest="passes", action="append", choices=PASSES,
        help="run only the named pass(es); default: all",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 1 if any error-severity finding remains (the CI gate)",
    )
    ap.add_argument(
        "--quick", action="store_true",
        help="subset the SPMD geometry sweep (smoke runs, not the gate)",
    )
    ap.add_argument("--json", action="store_true", help="emit the report as JSON")
    ap.add_argument(
        "--inventory", nargs="?", const=inventory_mod.DEFAULT_PATH,
        metavar="PATH", default=None,
        help="write the import-graph dead-code census and exit",
    )
    ap.add_argument(
        "--root", default=None,
        help="repo root override (default: inferred from the package path)",
    )
    args = ap.parse_args(argv)

    if args.inventory is not None:
        root = (
            pathlib.Path(args.root)
            if args.root
            else inventory_mod._repo_root()
        )
        out = root / args.inventory
        inv = inventory_mod.write_inventory(out, root=root)
        print(
            f"{out}: {inv['n_modules']} modules — {inv['n_reachable']} "
            f"reachable, {inv['n_seed_tier']} seed-tier, "
            f"{inv['n_test_only']} test-only, {len(inv['dead'])} dead "
            f"({inv['loc_dead']} LoC)"
        )
        for d in inv["dead"]:
            print(f"  dead: {d['module']} ({d['loc']} LoC, {d['defs']} defs)")
        return 0

    report = run_all(
        tuple(args.passes) if args.passes else PASSES,
        quick=args.quick,
        root=args.root,
    )
    print(report.to_json() if args.json else report.format())
    if args.strict and not report.ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
