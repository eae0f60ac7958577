"""Distributed concept mining on a Table-7-matched dataset (paper §5), on
the PyTorch port.

    PYTHONPATH=src python examples/fca_mining_torch.py --dataset mushroom --scale 0.03
    PYTHONPATH=src python examples/fca_mining_torch.py --device cpu

The port of ``examples/fca_mining.py``: MRGanter+ across a sweep of
partition counts (the paper's Figs 2–4 x-axis), reporting rounds, wall
time and modeled reduce-phase traffic for the two packed collective
schedules, each run's concept set against the centralized NextClosure.
``backend="kernel"``: on the card K1 and K2 on one shard, K1, K3 and K4
on several; on the CPU their plain versions.  ``main`` returns every run's
rounds, modeled bytes and agreement.
"""

import argparse
import time

from repro_torch.core import ClosureEngine, all_closures_batched, bitset, mrganter_plus
from repro_torch.data import fca_datasets


def main(dataset="mushroom", scale=0.03, parts=(1, 2, 4, 8), device=None) -> dict:
    ctx, spec = fca_datasets.load(dataset, scale=scale)
    print(f"{dataset}: {spec.n_objects} objects × {spec.n_attrs} attrs "
          f"@ {spec.density:.3f} density (scale={scale}, "
          f"{'synthetic' if spec.synthetic else 'real UCI'})")

    t0 = time.perf_counter()
    ref = all_closures_batched(ctx)
    print(f"NextClosure (centralized): {len(ref)} concepts "
          f"in {time.perf_counter() - t0:.2f}s")

    out = {"nextclosure": len(ref), "runs": {}}
    for k in parts:
        for impl in ("allgather", "rsag"):
            eng = ClosureEngine(ctx, n_parts=k, reduce_impl=impl, device=device)
            t0 = time.perf_counter()
            res = mrganter_plus(ctx, eng, dedupe_candidates=True)
            dt = time.perf_counter() - t0
            ok = {bitset.key_bytes(y) for y in res.intents} == {
                bitset.key_bytes(y) for y in ref
            }
            print(f"MRGanter+ parts={k} reduce={impl:9s}: "
                  f"{res.n_iterations:2d} rounds, {dt:5.2f}s, "
                  f"comm={res.modeled_comm_bytes / 1e6:7.2f} MB, match={ok}")
            out["runs"][(k, impl)] = {"concepts": res.n_concepts, "rounds": res.n_iterations,
                                      "comm_bytes": res.modeled_comm_bytes, "match": ok}
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="mushroom",
                   choices=list(fca_datasets.PAPER_DATASETS))
    p.add_argument("--scale", type=float, default=0.03)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args()
    main(dataset=a.dataset, scale=a.scale, device=a.device)
