"""FCA launcher of the port — mine, serve and rules over object shards.

    # mine (default subcommand)
    python -m repro_torch.launch.fca mine --dataset mushroom --scale 1.0 \
        --algorithm mrganter+ --min-support 0.05 --local-prune \
        --parts 8 --reduce rsag --backend kernel --device cuda

    # mine → build the device-resident concept store → serve a mixed
    # query/update batch (repro_torch.query)
    python -m repro_torch.launch.fca serve --dataset mushroom --scale 0.02 \
        --parts 4 --reduce auto --queries 256 --topk 32 --updates 8

    # iceberg-mine → extract the DG/Luxenburger bases → answer a
    # rule-query batch (repro_torch.rules)
    python -m repro_torch.launch.fca rules --dataset census-income \
        --scale 0.002 --parts 8 --min-support 0.05 --min-conf 0.5 \
        --rule-queries 128

``--parts`` object shards (default 8) are simulated on the one device,
unless the caller has initialized a ``torch.distributed`` group of more
than one rank: then every rank runs this command and holds one shard
(``ShardPlan.auto``), and ``--parts`` is not read.  ``--cand-shards C``
blocks the candidate (frontier) axis as well — the 2-D decomposition: C
simulated blocks on one device, or, under a group, a cand × pod × data
mesh of the ranks (:mod:`repro_torch.launch.mesh`; ``--pod`` only names
the object axes, as the pod's ranks share one object group), each rank holding one object shard and one candidate block.
``--mesh`` asks for that mesh even at C = 1 (``--mesh`` and ``--pod``
are refused without such a group); under ``torchrun`` it
initializes the default group from the environment itself.  ``--reduce`` picks the
AND-allreduce schedule of every round (``allgather``, ``rsag``, ``pmin``,
or ``auto``, which picks allgather or rsag per round from the batch size;
the per-round record lands in ``reduce_rounds``), and
``--calibrate-hops`` replaces the ``auto`` model's 4096 B latency default
with a measured probe (on a simulated plan the probe times torch ops on
one device and measures no wire).  ``--backend kernel`` runs the
hand-written CUDA kernels (the closure kernels while mining and serving,
K5 for top-k queries, K6 for rule queries); ``torch`` runs their plain
PyTorch versions, ``matmul`` the complement-plane matrix products for
every closure (``--no-kernel`` is the reference's deprecated spelling of
``--backend torch``).  ``--device`` defaults to ``cuda`` and the run fails
without a CUDA device unless ``--device cpu`` is given.
``--min-support`` takes an absolute object count (≥ 1) or a fraction of
|O| (in (0, 1)); the resolved count is echoed in the JSON stats.  The
printed keys are those of the reference's ``fca`` subcommands that the
port has; ``serve --load-qps`` (the admission queue) is not ported yet.

``--rounds async`` mines with speculative rounds: round r+1 is dispatched
against round r's survivors while their count is still on the device, and
round r is reconciled once round r+1 is in flight; the stats then count
``spec_rounds``, ``spec_fallbacks`` and ``spec_discarded``.

Observability (every subcommand): ``--trace out.json`` records every
mining round (with its expand / dispatch / allreduce / filter phases, or
for async rounds the ``spec/dispatch`` and ``spec/reconcile`` spans on the
round's async track; ``python -m repro_torch.obs.trace out.json
--expect-async-overlap`` checks that a dispatch overlapped a round),
query micro-batch and stream stage/commit as a Chrome/Perfetto timeline
(validate with ``python -m repro_torch.obs.trace out.json``) and adds a
per-span ``span_rollup`` and the ``trace_path`` to the printed stats;
``--stats-json PATH`` also writes those stats to a file;
``--device-trace DIR`` runs a ``torch.profiler`` session beside it,
exports its Chrome trace into DIR and adds its ``device_trace_path``; the
command fails if the session does not start or the export fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core import ClosureEngine, bitset
from repro_torch.core.engine import BACKENDS
from repro_torch.core.mr import PIPELINES, ROUNDS
from repro_torch.data import fca_datasets
from repro_torch.dist import ShardPlan
from repro_torch.dist.collectives import IMPLS
from repro_torch.dist.shardplan import GROUP_BACKENDS
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.obs import (
    Tracer, span_rollup, start_device_trace, stop_device_trace, use_tracer,
)
from repro_torch.obs.trace import DEVICE_TRACE_FILE
from repro_torch.query import ConceptStore, QueryConfig, QueryEngine, StreamUpdater
from repro_torch.rules import (
    ALGORITHMS, RuleIndex, extract_bases, resolve_min_support, rule_query_mix,
)


def build_plan(args) -> ShardPlan:
    """The run's ShardPlan from the CLI geometry flags: simulated shards
    and candidate blocks on one device, or — under a group of more than
    one rank — one shard per rank, over a cand × pod × data mesh where
    ``--cand-shards``, ``--pod`` or ``--mesh`` ask for one."""
    kw = {"reduce_impl": args.reduce, "calibrate_hops": args.calibrate_hops}
    grouped = dist.is_initialized() and dist.get_world_size() > 1
    if grouped and (args.mesh or args.cand_shards > 1 or args.pod > 1):
        mesh = make_local_mesh(pod=args.pod, cand=args.cand_shards)
        return ShardPlan.over_mesh(mesh, args.device, **kw)
    if grouped:
        return ShardPlan.auto(args.parts, device=args.device, **kw)
    if args.mesh or args.pod > 1:
        raise SystemExit("--mesh and --pod need a torch.distributed group of more than one rank")
    return ShardPlan.simulated(args.parts, cand_parts=args.cand_shards,
                               device=args.device, **kw)


def _mine(args, ctx, plan, min_support):
    eng = ClosureEngine(ctx, plan=plan, backend=args.backend, device=args.device)
    kw = {"pipeline": args.pipeline, "rounds": args.rounds, "min_support": min_support}
    if args.algorithm == "mrganter+":
        kw["local_prune"] = args.local_prune
    res = ALGORITHMS[args.algorithm](
        ctx, eng, max_iterations=args.max_iterations, **kw
    )
    return eng, res


def _resolved_min_support(args, ctx) -> int | None:
    if args.min_support is None:
        return None
    return resolve_min_support(args.min_support, ctx.n_objects)


def _load(args):
    """The command's context, its dataset spec and the run's plan (and the
    run's backend, ``--no-kernel`` resolved)."""
    if args.backend is None:
        args.backend = "torch" if args.no_kernel else "kernel"
    elif args.no_kernel:
        print("--no-kernel is deprecated and ignored when --backend is given",
              file=sys.stderr)
        args.no_kernel = False
    ctx, spec = fca_datasets.load(args.dataset, scale=args.scale, data_dir=args.data_dir)
    return ctx, spec, build_plan(args)


def cmd_mine(args) -> dict:
    ctx, spec, plan = _load(args)
    eng, res = _mine(args, ctx, plan, _resolved_min_support(args, ctx))
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
        "rounds": args.rounds,
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
        "spec_rounds": eng.stats.spec_rounds,
        "spec_fallbacks": eng.stats.spec_fallbacks,
        "spec_discarded": eng.stats.spec_discarded,
        "wall_time_s": round(res.wall_time_s, 3),
    }


def serve_queries(ctx, n: int, rng) -> np.ndarray:
    """The serve batch: real rows with ~25% of their bits kept, so
    closures hit populated regions of the lattice (the reference CLI's
    generator, drawn from the same ``rng`` in the same order)."""
    base = ctx.rows[rng.integers(0, ctx.n_objects, size=n)]
    keep = bitset.pack_bool(rng.random((n, ctx.n_attrs)) < 0.25, ctx.W)
    return base & keep


def cmd_serve(args) -> dict:
    """mine → build store → serve one mixed query/update batch."""
    ctx, spec, plan = _load(args)
    eng, res = _mine(args, ctx, plan, _resolved_min_support(args, ctx))

    t0 = time.perf_counter()
    store = ConceptStore.build(ctx, res.intents, plan=eng.plan, device=eng.device)
    build_s = time.perf_counter() - t0
    qe = QueryEngine(store, QueryConfig(slots=args.slots, backend=args.backend))

    rng = np.random.default_rng(args.seed)
    queries = serve_queries(ctx, args.queries, rng)

    t0 = time.perf_counter()
    closures, supports, ids = qe.closure_batch(queries)
    tops, top_supports = qe.topk_batch(queries[: args.topk], k=5)
    hit_ids = ids[ids >= 0]
    trav = qe.children(hit_ids[:8]) if hit_ids.size else []
    query_s = time.perf_counter() - t0

    # streaming update: synthetic rows matched to the context density.
    # Skipped for iceberg serves: Godin insertion maintains the FULL intent
    # family, so streaming onto an iceberg store would drift to neither
    # the full nor the iceberg lattice of the grown context.
    receipt, update_s, post_ids = None, None, ids
    if res.min_support is None:
        upd = StreamUpdater(store)
        new_rows = bitset.pack_bool(
            rng.random((args.updates, ctx.n_attrs)) < max(0.05, spec.density), ctx.W
        )
        t0 = time.perf_counter()
        receipt = upd.stage(new_rows)
        upd.commit()
        update_s = time.perf_counter() - t0
        post_ids = qe.lookup_batch(closures)  # same intents, new snapshot
    elif args.updates:
        print(
            "serve --min-support: skipping the streaming-update phase "
            "(Godin insertion maintains the full family, not an iceberg)",
            file=sys.stderr,
        )

    n_q = args.queries + min(args.queries, args.topk)
    return {
        "dataset": spec.name,
        "plan": plan.describe(),
        "backend": args.backend,
        "device": str(eng.device),
        "algorithm": res.algorithm,
        "min_support_resolved": res.min_support,
        "concepts": res.n_concepts,
        "mine_wall_s": round(res.wall_time_s, 3),
        "store": store.describe(),
        "store_build_s": round(build_s, 3),
        "slots": args.slots,
        "queries": int(n_q),
        "query_wall_s": round(query_s, 4),
        "queries_per_s": round(n_q / max(query_s, 1e-9), 1),
        "closure_hit_rate": round(float((ids >= 0).mean()), 4) if ids.size else None,
        "traversal_children_sample": [len(t) for t in trav],
        "top_support_max": int(top_supports.max()) if top_supports.size else None,
        "update": None if receipt is None else dataclasses.asdict(receipt),
        "update_commit_s": None if update_s is None else round(update_s, 4),
        "post_update_version": store.snapshot.version,
        "post_update_hit_rate": (
            round(float((post_ids >= 0).mean()), 4) if post_ids.size else None
        ),
        "query_stats": qe.describe()["stats"],
    }


def cmd_rules(args) -> dict:
    """iceberg-mine → store → extract DG + Luxenburger bases → serve a
    rule-query batch through the QueryEngine's fixed-slot rule ops."""
    ctx, spec, plan = _load(args)
    min_support = _resolved_min_support(args, ctx)
    if min_support is None:  # rules without a threshold = iceberg at 1
        min_support = 1
    eng, res = _mine(args, ctx, plan, min_support)

    t0 = time.perf_counter()
    store = ConceptStore.build(ctx, res.intents, plan=eng.plan, device=eng.device)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    basis = extract_bases(store, min_conf=args.min_conf)
    index = RuleIndex.build(basis, plan=eng.plan, device=eng.device)
    basis_s = time.perf_counter() - t0

    qe = QueryEngine(store, QueryConfig(slots=args.slots, backend=args.backend))
    rng = np.random.default_rng(args.seed)
    n_q = args.rule_queries
    queries = rule_query_mix(ctx, index, n_q, rng)

    t0 = time.perf_counter()
    ids, scores, consequents = qe.rules_batch(
        index, queries, k=args.topk_rules, min_conf=args.min_conf, rank_by=args.rank_by,
    )
    query_s = time.perf_counter() - t0
    hits = ids[:, 0] >= 0

    return {
        "dataset": spec.name,
        "plan": plan.describe(),
        "backend": args.backend,
        "device": str(eng.device),
        "algorithm": res.algorithm,
        "min_support_resolved": min_support,
        "min_conf": args.min_conf,
        "iceberg_concepts": res.n_concepts,
        "mine_iterations": res.n_iterations,
        "mine_wall_s": round(res.wall_time_s, 3),
        "store_build_s": round(build_s, 3),
        "basis": basis.describe(),
        "rule_index": index.describe(),
        "basis_extract_s": round(basis_s, 3),
        "rule_queries": int(n_q),
        "rank_by": args.rank_by,
        "rule_query_wall_s": round(query_s, 4),
        "rule_queries_per_s": round(n_q / max(query_s, 1e-9), 1),
        "rule_hit_rate": round(float(hits.mean()), 4) if n_q else None,
        "top_score_max": float(scores.max()) if scores.size else None,
        "consequent_bits_mean": (
            round(float(bitset.popcount(consequents).mean()), 2) if n_q else None
        ),
        "reduce_rounds": eng.stats.reduce_rounds,
        "query_stats": qe.describe()["stats"],
    }


COMMANDS = {"mine": cmd_mine, "serve": cmd_serve, "rules": cmd_rules}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.fca")
    p.add_argument("command", nargs="?", default="mine", choices=list(COMMANDS),
                   help="mine (default): run an MR* miner; serve: mine, build "
                        "the concept store, then run a mixed query/update "
                        "batch; rules: iceberg-mine, extract the "
                        "DG/Luxenburger bases, answer a rule-query batch")
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
    p.add_argument("--cand-shards", type=int, default=1,
                   help="2-D decomposition: block the candidate (frontier) axis "
                        "over this many simulated blocks, or under a group a "
                        "candidate axis of the rank mesh; one round then absorbs "
                        "cand-shards x max_batch candidates")
    p.add_argument("--mesh", action="store_true",
                   help="build the plan over a cand x pod x data mesh of the "
                        "torch.distributed ranks (initialized from the "
                        "environment under torchrun)")
    p.add_argument("--pod", type=int, default=1,
                   help="pod axis size of the rank mesh; it only names the "
                        "object axes (pod x data ranks share one object group), "
                        "and needs a torch.distributed group like --mesh")
    p.add_argument("--reduce", default="rsag", choices=list(IMPLS) + ["auto"],
                   help="AND-allreduce schedule of the reduce phase; auto "
                        "picks allgather or rsag per round")
    p.add_argument("--calibrate-hops", action="store_true",
                   help="measure the auto schedule's per-hop latency term "
                        "instead of the 4096 B default (on a simulated plan "
                        "this times torch ops on one device, no wire)")
    p.add_argument("--pipeline", default="device", choices=list(PIPELINES))
    p.add_argument("--rounds", default="sync", choices=list(ROUNDS),
                   help="sync: every round's survivor count read before the next is "
                        "dispatched; async: speculative rounds chained on the device "
                        "count (device pipeline only)")
    p.add_argument("--backend", default=None, choices=list(BACKENDS),
                   help="kernel (default): the hand-written CUDA kernels; torch: "
                        "their plain versions; matmul: complement-plane products")
    p.add_argument("--no-kernel", action="store_true",
                   help="deprecated: use --backend torch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--data-dir", default=None,
                   help="directory holding real UCI <dataset>.data files")
    # serve-only knobs
    p.add_argument("--queries", type=int, default=256,
                   help="serve: closure queries in the mixed batch")
    p.add_argument("--topk", type=int, default=32,
                   help="serve: top-k queries in the mixed batch")
    p.add_argument("--updates", type=int, default=8,
                   help="serve: streamed new objects in the update batch")
    p.add_argument("--slots", type=int, default=64,
                   help="serve/rules: fixed micro-batch slot width")
    p.add_argument("--seed", type=int, default=0)
    # rules-only knobs
    p.add_argument("--min-conf", type=float, default=0.5,
                   help="rules: Luxenburger basis + query confidence floor")
    p.add_argument("--rule-queries", type=int, default=128,
                   help="rules: rule-query batch size")
    p.add_argument("--topk-rules", type=int, default=5,
                   help="rules: top-k rules returned per query")
    p.add_argument("--rank-by", default="confidence", choices=["confidence", "lift"],
                   help="rules: top-k rank metric")
    # observability (every subcommand)
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="write a Chrome/Perfetto trace_event JSON timeline of the "
                        "run (mining rounds with their expand/dispatch/allreduce/"
                        "filter phases, query micro-batches, stream stage/commit) "
                        "to PATH; validate with `python -m repro_torch.obs.trace PATH`")
    p.add_argument("--stats-json", metavar="PATH", default=None,
                   help="also write the run's JSON stats to PATH (with --trace "
                        "they carry a per-span latency rollup)")
    p.add_argument("--device-trace", metavar="DIR", default=None,
                   help="run a torch.profiler session beside the run and export "
                        "its Chrome trace into DIR")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # --mesh under torchrun: this command owns the default group it starts
    owns_group = args.mesh and not dist.is_initialized() and "WORLD_SIZE" in os.environ
    if owns_group:
        dist.init_process_group(GROUP_BACKENDS[args.device])
    tracer = Tracer() if args.trace else None
    exported = False
    try:
        if args.device_trace and not start_device_trace(args.device_trace):
            raise SystemExit("--device-trace: the torch.profiler session did not start")
        with use_tracer(tracer):
            out = COMMANDS[args.command](args)
    finally:
        if args.device_trace:
            exported = stop_device_trace()
        if owns_group:
            dist.destroy_process_group()
    if args.device_trace:
        if not exported:
            raise SystemExit(f"--device-trace: exporting the profiler's trace into "
                             f"{args.device_trace} failed")
        out["device_trace_path"] = os.path.join(args.device_trace, DEVICE_TRACE_FILE)
    if tracer is not None:
        tracer.save(args.trace)
        out["trace_path"] = args.trace
        out["span_rollup"] = span_rollup(tracer.to_dict()["traceEvents"])
    if args.stats_json:
        with open(args.stats_json, "w") as fh:
            json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
