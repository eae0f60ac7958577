"""The port's object-sharded mining on census-income at scale 0.001 against
the committed ``BENCH_dist.json`` (the reference's benchmark record): the
``pruning_ab`` rows at k = 8 under every schedule with and without local
pruning, and the ``scaling`` rows at k ∈ {1, 2, 4}.  Split from
``tests/test_torch_shardplan.py``, whose helpers it shares.
Tolerance: exact equality of counts and bytes.
"""

from __future__ import annotations

import json

import pytest

import repro_torch.core as core
from repro_torch.data import fca_datasets

from test_torch_shardplan import ROOT


def _bench_dist() -> dict:
    return json.loads((ROOT / "BENCH_dist.json").read_text())


def _census_row(res, eng) -> dict:
    rounds = max(1, eng.stats.rounds)
    return {
        "n_concepts": res.n_concepts,
        "n_iterations": res.n_iterations,
        "closures_computed": eng.stats.closures_computed,
        "rounds": rounds,
        "reduce_bytes_total": eng.stats.modeled_comm_bytes,
        "reduce_bytes_per_round": eng.stats.modeled_comm_bytes // rounds,
    }


CENSUS_BACKENDS = {"allgather": "matmul", "rsag": "kernel", "pmin": "torch"}


@pytest.mark.parametrize("local_prune", [False, True])
@pytest.mark.parametrize("impl", ["allgather", "rsag", "pmin"])
def test_census_pruning_ab_matches_bench_dist(impl, local_prune):
    """BENCH_dist.json ``pruning_ab`` (k = 8, census-income at scale 0.001):
    532 concepts, 7 iterations, 68,100 → 37,177 closures and, under rsag,
    2,969,920 → 1,736,000 B/round without and with local pruning."""
    (want,) = [r for r in _bench_dist()["pruning_ab"]
               if r["plan"]["reduce_impl"] == impl and r["local_prune"] == local_prune]
    ctx, _ = fca_datasets.load("census-income", scale=0.001, seed=0)
    eng = core.ClosureEngine(ctx, n_parts=8, reduce_impl=impl,
                             backend=CENSUS_BACKENDS[impl], device="cpu")
    res = core.mrganter_plus(ctx, eng, local_prune=local_prune)
    assert _census_row(res, eng) == {k: want[k] for k in _census_row(res, eng)}
    assert eng.plan.describe()["n_parts"] == want["plan"]["n_parts"] == 8


@pytest.mark.parametrize("k", [1, 2, 4])
def test_census_scaling_matches_bench_dist(k):
    """BENCH_dist.json ``scaling`` (local pruning) at every schedule."""
    ctx, _ = fca_datasets.load("census-income", scale=0.001, seed=0)
    for want in _bench_dist()["scaling"]:
        if want["plan"]["n_parts"] != k:
            continue
        eng = core.ClosureEngine(ctx, n_parts=k, reduce_impl=want["plan"]["reduce_impl"],
                                 backend="kernel", device="cpu")
        res = core.mrganter_plus(ctx, eng, local_prune=True)
        assert _census_row(res, eng) == {k_: want[k_] for k_ in _census_row(res, eng)}
