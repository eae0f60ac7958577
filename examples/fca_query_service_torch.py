"""Concept-lattice query service on the PyTorch port: mine once, serve
forever, update in place.

    PYTHONPATH=src python examples/fca_query_service_torch.py \
        --dataset mushroom --scale 0.01 --parts 4 --reduce auto [--device cpu]

The port of ``examples/fca_query_service.py``, end to end through
``repro_torch.query`` with ``backend="kernel"`` (on the card: K1, K3 and
K4 for mining on the simulated shards, K1 and K5 for serving; on the CPU
their plain versions):

  1. mine the dataset with MRGanter+ on a ShardPlan (device pipeline);
  2. build the device-resident ConceptStore on the *same* plan — intent
     table + two-level hash index replicated, context rows and extent
     table object-sharded, covering relation from the subset-test matmul;
  3. serve micro-batched queries (closure-of-attrset with concept lookup,
     top-k-by-support, covering-relation traversal) — each micro-batch is
     one SPMD collective round;
  4. stream a batch of new objects through the Godin-style device
     insertion: queries keep working between ``stage()`` and
     ``commit()``, and after the swap the grown lattice equals a
     from-scratch remine (asserted below).

``main`` returns the counts it printed.
"""

import argparse
import time

import numpy as np

from repro_torch.core import ClosureEngine, all_closures_batched, bitset, mrganter_plus
from repro_torch.data import fca_datasets
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.query import ConceptStore, QueryEngine, StreamUpdater
from repro_torch.query.engine import QueryConfig


def main(dataset="mushroom", scale=0.01, parts=4, reduce_impl="auto",
         queries=256, updates=6, seed=0, device=None) -> dict:
    ctx, spec = fca_datasets.load(dataset, scale=scale)
    print(f"{dataset}: {spec.n_objects} objects × {spec.n_attrs} attrs "
          f"@ {spec.density:.3f} density")

    plan = ShardPlan.simulated(parts, reduce_impl=reduce_impl)
    eng = ClosureEngine(ctx, plan=plan, backend="kernel", device=device)
    res = mrganter_plus(ctx, eng, local_prune=True)
    print(f"mined {res.n_concepts} concepts in {res.n_iterations} rounds "
          f"({res.wall_time_s:.2f}s)")

    t0 = time.perf_counter()
    store = ConceptStore.build(ctx, res.intents, plan=plan, device=device)
    qe = QueryEngine(store, QueryConfig(slots=64, backend="kernel"))
    print(f"store built in {time.perf_counter() - t0:.2f}s: "
          f"{store.describe()}")

    rng = np.random.default_rng(seed)
    base = ctx.rows[rng.integers(0, ctx.n_objects, size=queries)]
    keep = bitset.pack_bool(rng.random((queries, ctx.n_attrs)) < 0.25, ctx.W)
    attrsets = base & keep

    qe.closure_batch(attrsets[:64])  # warm the steps
    t0 = time.perf_counter()
    closures, supports, ids = qe.closure_batch(attrsets)
    dt = time.perf_counter() - t0
    print(f"closure×{queries}: {queries / dt:,.0f} q/s, "
          f"hit rate {(ids >= 0).mean():.2f}, "
          f"{qe.stats.collective_rounds} collective rounds "
          f"(schedule: {qe.stats.reduce_rounds})")

    tops, tvals = qe.topk_batch(attrsets[:32], k=5)
    kids = qe.children(ids[ids >= 0][:5])
    print(f"top-5 support of query 0: {tvals[0].tolist()}; "
          f"children counts sample: {[len(k) for k in kids]}")

    # streaming: stage, query mid-flight, commit, verify vs remine
    upd = StreamUpdater(store)
    new_rows = bitset.pack_bool(
        rng.random((updates, ctx.n_attrs)) < max(0.05, spec.density), ctx.W)
    receipt = upd.stage(new_rows)
    mid_ids = qe.lookup_batch(closures)  # still serving the OLD snapshot
    assert np.array_equal(mid_ids, ids), "stage must not disturb serving"
    upd.commit()
    print(f"streamed {updates} objects: {receipt.n_concepts_before} → "
          f"{receipt.n_concepts_after} concepts, "
          f"staged in {receipt.stage_wall_s:.2f}s "
          f"(|P|={receipt.n_intersections})")

    ref = all_closures_batched(store.ctx)
    same = {bitset.key_bytes(y) for y in ref} == {
        bitset.key_bytes(y) for y in store.snapshot.intents_np
    }
    print(f"grown lattice == batch NextClosure remine: {same}")
    return {"concepts": res.n_concepts, "rounds": res.n_iterations,
            "hit_rate": float((ids >= 0).mean()),
            "collective_rounds": qe.stats.collective_rounds,
            "reduce_rounds": dict(qe.stats.reduce_rounds),
            "top5_query0": tvals[0].tolist(), "children": [len(k) for k in kids],
            "concepts_before": receipt.n_concepts_before,
            "concepts_after": receipt.n_concepts_after,
            "intersections": receipt.n_intersections, "remine_equal": same}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="mushroom",
                   choices=list(fca_datasets.PAPER_DATASETS))
    p.add_argument("--scale", type=float, default=0.01)
    p.add_argument("--parts", type=int, default=4)
    p.add_argument("--reduce", default="auto")
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--updates", type=int, default=6)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args()
    main(dataset=a.dataset, scale=a.scale, parts=a.parts,
         reduce_impl=a.reduce, queries=a.queries, updates=a.updates, device=a.device)
