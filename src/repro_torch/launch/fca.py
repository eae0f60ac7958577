"""FCA launcher of the port — mine one context on one object shard.

    python -m repro_torch.launch.fca mine --dataset mushroom --scale 1.0 \
        --algorithm mrganter+ --min-support 0.05 --local-prune \
        --backend kernel --device cuda

``--backend kernel`` runs the hand-written CUDA kernels (``torch`` runs
their plain PyTorch versions); ``--device`` defaults to ``cuda`` and the
run fails without a CUDA device unless ``--device cpu`` is given.
``--min-support`` takes an absolute object count (≥ 1) or a fraction of
|O| (in (0, 1)); the resolved count is echoed in the JSON stats.  The
printed keys are those of the reference's ``fca mine`` that this slice
of the port has.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import ClosureEngine
from repro_torch.core.engine import BACKENDS
from repro_torch.core.mr import PIPELINES
from repro_torch.data import fca_datasets
from repro_torch.rules import ALGORITHMS, resolve_min_support


def cmd_mine(args) -> dict:
    ctx, spec = fca_datasets.load(
        args.dataset, scale=args.scale, data_dir=args.data_dir
    )
    eng = ClosureEngine(ctx, backend=args.backend, device=args.device)
    min_support = (
        None
        if args.min_support is None
        else resolve_min_support(args.min_support, ctx.n_objects)
    )
    kw = {"pipeline": args.pipeline, "min_support": min_support}
    if args.algorithm == "mrganter+":
        kw["local_prune"] = args.local_prune
    res = ALGORITHMS[args.algorithm](
        ctx, eng, max_iterations=args.max_iterations, **kw
    )
    return {
        "dataset": spec.name,
        "objects": spec.n_objects,
        "attributes": spec.n_attrs,
        "density": round(spec.density, 4),
        "synthetic": spec.synthetic,
        "plan": eng.plan.describe(),
        "backend": args.backend,
        "device": str(eng.device),
        "pipeline": args.pipeline,
        "rounds": "sync",
        "algorithm": res.algorithm,
        "min_support_resolved": res.min_support,
        "concepts": res.n_concepts,
        "iterations": res.n_iterations,
        "closures_computed": res.n_closures_computed,
        "modeled_comm_bytes": res.modeled_comm_bytes,
        "modeled_dispatch_bytes": eng.stats.modeled_dispatch_bytes,
        "modeled_collective_bytes": eng.stats.modeled_collective_bytes,
        "reduce_rounds": eng.stats.reduce_rounds,
        "dispatch_s": round(eng.stats.dispatch_s, 4),
        "host_blocked_s": round(eng.stats.host_blocked_s, 4),
        "wall_time_s": round(res.wall_time_s, 3),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.fca")
    p.add_argument("command", nargs="?", default="mine", choices=["mine"],
                   help="mine (default): run an MR* miner")
    p.add_argument("--dataset", default="mushroom",
                   choices=sorted(fca_datasets.PAPER_DATASETS))
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--algorithm", default="mrganter+", choices=list(ALGORITHMS))
    p.add_argument("--min-support", type=float, default=None,
                   help="absolute object count (>= 1) or fraction of |O|")
    p.add_argument("--local-prune", action="store_true",
                   help="MRGanter+: drop duplicate seeds before the closure")
    p.add_argument("--pipeline", default="device", choices=list(PIPELINES))
    p.add_argument("--backend", default="kernel", choices=list(BACKENDS))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="directory holding real UCI <dataset>.data files")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    print(json.dumps(cmd_mine(args), indent=2))


if __name__ == "__main__":
    main()
