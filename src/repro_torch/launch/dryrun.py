"""Multi-pod dry-run CLI.

    python -m repro_torch.launch.dryrun --arch <id> --shape <s> [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod] --out dryrun.jsonl
    python -m repro_torch.launch.dryrun --fca [--multi-pod]
    python -m repro_torch.launch.dryrun --cell <id>:<s> [--cell ...] [--fca]

The counterpart of the reference's ``repro.launch.dryrun``.  It starts a
fake ``torch.distributed`` group (``FakeStore``: no process, no network)
of 256 ranks — 512 with ``--multi-pod`` — as rank 0, builds the
production mesh on it (``make_production_mesh``: 16 × 16 data × model, or
2 × 16 × 16), and traces every cell's real train, prefill or decode step
against fake inputs (``repro_torch.launch.dryrun_lib``): one JSON record
per cell on stdout (and appended to ``--out``), the per-device FLOPs, HBM
bytes, collective bytes, state and cache bytes and memory of rank 0, and
a summary line on stderr; the exit code is 1 when a cell errs.

``--device`` is the fake tensors' device: ``cuda`` (default; the steps
then trace K7 and K7b, which need no card to be traced) or ``cpu`` (the
plain attention, for a torch built without CUDA, whose autograd cannot
hold fake CUDA tensors).  The fake group is the process's default group:
run this in a process of its own (it refuses to start inside another
group).
"""

from __future__ import annotations

import argparse
import json
import sys


def start_fake_group(world_size: int) -> None:
    """A fake default group of ``world_size`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed group is already running in this process; "
                           "run the dry-run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--cell", action="append", default=[], metavar="ARCH:SHAPE",
                   help="a cell to run (repeatable; --fca adds the FCA cell after them)")
    p.add_argument("--fca", action="store_true", help="paper's own technique cell")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default=None, help="append JSONL records here")
    p.add_argument("--fsdp", default=None, choices=["on", "off"])
    p.add_argument("--baseline", action="store_true",
                   help="disable the attention sharding constraints (A/B baseline)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the fake tensors' device")
    args = p.parse_args(argv)

    cells = [tuple(c.split(":", 1)) for c in args.cell]
    if any(len(c) != 2 for c in cells):
        p.error("--cell takes ARCH:SHAPE")
    if args.fca:
        cells.append("__fca__")
    elif args.all:
        from repro_torch.configs import ARCH_IDS, SHAPES

        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif not cells:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required (or --all / --fca / --cell)")
        cells = [(args.arch, args.shape)]

    import torch
    import torch.distributed as dist

    if args.device == "cuda" and torch.version.cuda is None:
        p.error("this torch is built without CUDA, and its autograd cannot hold fake CUDA "
                "tensors: pass --device cpu")

    from repro_torch.launch.dryrun_lib import run_cell, run_fca_cell
    from repro_torch.launch.mesh import make_production_mesh

    start_fake_group(512 if args.multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=args.device)
        mesh_label = "2x16x16" if args.multi_pod else "16x16"
        fsdp = None if args.fsdp is None else (args.fsdp == "on")
        records = []
        for cell in cells:
            if cell == "__fca__":
                rec = run_fca_cell(mesh, mesh_label, baseline=args.baseline, device=args.device)
            else:
                arch, shape = cell
                rec = run_cell(arch, shape, mesh, mesh_label, fsdp=fsdp,
                               baseline=args.baseline, device=args.device)
            records.append(rec)
            rec["variant"] = "baseline" if args.baseline else "optimized"
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    finally:
        dist.destroy_process_group()

    n_err = sum(r["status"] == "error" for r in records)
    print(f"# {len(records)} cells: "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skipped' for r in records)} skipped, "
          f"{n_err} errors", file=sys.stderr)
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
