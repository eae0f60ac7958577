"""FCA launcher of the port — mine one context over object shards.

    python -m repro_torch.launch.fca mine --dataset mushroom --scale 1.0 \
        --algorithm mrganter+ --min-support 0.05 --local-prune \
        --parts 8 --reduce rsag --backend kernel --device cuda

``--parts`` object shards (default 8) are simulated on the one device,
unless the caller has initialized a ``torch.distributed`` group of more
than one rank: then every rank runs this command and holds one shard
(``ShardPlan.auto``), and ``--parts`` is not read.  ``--reduce`` picks the AND-allreduce schedule of every round
(``allgather``, ``rsag``, ``pmin``, or ``auto``, which picks allgather or
rsag per round from the batch size; the per-round record lands in
``reduce_rounds``), and ``--calibrate-hops`` replaces the ``auto`` model's
4096 B latency default with a measured probe (on a simulated plan the
probe times torch ops on one device and measures no wire).  ``--backend kernel`` runs
the hand-written CUDA kernels (``torch`` runs their plain PyTorch
versions, ``matmul`` the complement-plane matrix products); ``--device``
defaults to ``cuda`` and the run fails without a CUDA device unless
``--device cpu`` is given.
``--min-support`` takes an absolute object count (≥ 1) or a fraction of
|O| (in (0, 1)); the resolved count is echoed in the JSON stats.  The
printed keys are those of the reference's ``fca mine`` that the port
has.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import ClosureEngine
from repro_torch.core.engine import BACKENDS
from repro_torch.core.mr import PIPELINES
from repro_torch.data import fca_datasets
from repro_torch.dist import ShardPlan
from repro_torch.dist.collectives import IMPLS
from repro_torch.rules import ALGORITHMS, resolve_min_support


def build_plan(args) -> ShardPlan:
    """The run's ShardPlan from the CLI geometry flags."""
    return ShardPlan.auto(
        args.parts,
        reduce_impl=args.reduce,
        calibrate_hops=args.calibrate_hops,
        device=args.device,
    )


def cmd_mine(args) -> dict:
    ctx, spec = fca_datasets.load(
        args.dataset, scale=args.scale, data_dir=args.data_dir
    )
    eng = ClosureEngine(ctx, plan=build_plan(args), backend=args.backend,
                        device=args.device)
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
    p.add_argument("--parts", type=int, default=8,
                   help="object shards, simulated on the one device; under "
                        "an initialized torch.distributed group of more than "
                        "one rank, one shard per rank instead")
    p.add_argument("--reduce", default="rsag", choices=list(IMPLS) + ["auto"],
                   help="AND-allreduce schedule of the reduce phase; auto "
                        "picks allgather or rsag per round")
    p.add_argument("--calibrate-hops", action="store_true",
                   help="measure the auto schedule's per-hop latency term "
                        "instead of the 4096 B default (on a simulated plan "
                        "this times torch ops on one device, no wire)")
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
