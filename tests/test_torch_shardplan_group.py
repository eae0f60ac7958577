"""The port's ShardPlan over a real process group (4 gloo ranks on the CPU,
one object shard each, and a 2 x 2 candidate x object mesh) against the
JAX package's simulated plans, and the ``fca mine`` CLI on the CPU against
the committed ``BENCH_dist.json``.  Split from
``tests/test_torch_shardplan.py``, whose helpers it shares; the reference's
engine rounds need the jax-0.9 binding of the ``jax_reference`` fixture.
Tolerance: exact equality of intents (in order), counts and bytes.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import repro.core as ref_core
from repro.dist import shardplan as ref_sp
from repro_torch.launch import fca

from _torch_reference import jax_reference  # noqa: F401
from test_torch_collectives import run_ranks
from test_torch_shardplan import (DRIVERS, IMPLS, ROOT, _context, _port, _reference,
                                  _reference_runs, _summary)
from test_torch_shardplan_census import _bench_dist


# -- a real process group: 4 gloo ranks on the CPU ---------------------------

GROUP_BODY = """
import dataclasses
import repro_torch.core as core
from repro_torch.core.engine import EngineStats
from repro_torch.dist.shardplan import ShardPlan

STAT_FIELDS = [f.name for f in dataclasses.fields(EngineStats) if f.type in ("int", "dict")]
DRIVERS = {
    "mrganter": lambda c, e: core.mrganter(c, e),
    "mrganter+": lambda c, e: core.mrganter_plus(c, e, dedupe_candidates=True),
    "mrcbo": lambda c, e: core.mrcbo(c, e),
}
ctx = core.paper_context()
out = {}
for impl in ("allgather", "rsag", "pmin", "auto"):
    for backend in ("kernel", "torch"):
        plan = ShardPlan.over_group(None, "cpu", reduce_impl=impl)
        for name, drive in DRIVERS.items():
            eng = core.ClosureEngine(ctx, plan=plan, backend=backend)
            res = drive(ctx, eng)
            out[f"{impl}/{backend}/{name}"] = {
                "intents": [y.tobytes().hex() for y in res.intents],
                "iterations": res.n_iterations,
                "closures": res.n_closures_computed,
                "bytes": res.modeled_comm_bytes,
                "stats": {k: getattr(eng.stats, k) for k in STAT_FIELDS},
            }
calibrated = ShardPlan.over_group(None, "cpu", reduce_impl="auto", calibrate_hops=True)
eng = core.ClosureEngine(ctx, plan=calibrated, backend="matmul")
res = core.mrcbo(ctx, eng)
out["calibrated"] = {
    "hop": [calibrated.auto_hop_bytes, calibrated.hop_calibrated],
    "intents": [y.tobytes().hex() for y in res.intents],
    "describe": calibrated.describe(),
    "device": str(eng.device), "rows": list(eng.rows.shape),
}
try:
    ShardPlan.over_group(None, "cuda")
except Exception as e:
    out["cuda"] = type(e).__name__
from repro_torch.launch import fca
cli = fca.cmd_mine(fca.build_parser().parse_args(
    ["mine", "--dataset", "census-income", "--scale", "0.001", "--local-prune",
     "--reduce", "rsag", "--device", "cpu"]))
out["cli"] = {k: cli[k] for k in ("plan", "concepts", "iterations", "closures_computed",
                                  "modeled_comm_bytes", "reduce_rounds")}

# the 2-D plan: a 2 x 2 (candidate x object) mesh of the four ranks
from repro_torch.launch.mesh import make_local_mesh
mesh = make_local_mesh(cand=2)
synthetic = core.FormalContext.synthetic(60, 24, 0.35, seed=42)
MESH_DRIVERS = dict(DRIVERS, **{
    "mrganter+dedupe": lambda c, e: core.mrganter_plus(c, e, dedupe_closures=True),
    "mrganter+iceberg": lambda c, e: core.mrganter_plus(c, e, local_prune=True, min_support=6),
    "mrcbo+iceberg": lambda c, e: core.mrcbo(c, e, min_support=6),
})
out["mesh"] = {"rank": dist.get_rank(), "object": dist.get_rank(mesh.object_group),
               "cand": dist.get_rank(mesh.cand_group)}
for impl in ("allgather", "rsag", "pmin", "auto"):
    for backend in ("kernel", "torch"):
        plan = ShardPlan.over_mesh(mesh, "cpu", reduce_impl=impl)
        for name, drive in DRIVERS.items():
            eng = core.ClosureEngine(ctx, plan=plan, backend=backend)
            res = drive(ctx, eng)
            out[f"2d/{impl}/{backend}/{name}"] = {
                "intents": [y.tobytes().hex() for y in res.intents],
                "iterations": res.n_iterations,
                "closures": res.n_closures_computed,
                "bytes": res.modeled_comm_bytes,
                "stats": {k: getattr(eng.stats, k) for k in STAT_FIELDS},
            }
for backend in ("kernel", "torch"):
    plan = ShardPlan.over_mesh(mesh, "cpu", reduce_impl="rsag", block_n=64, max_batch=64)
    for name, drive in MESH_DRIVERS.items():
        if name == "mrganter":
            continue
        eng = core.ClosureEngine(synthetic, plan=plan, backend=backend)
        res = drive(synthetic, eng)
        out[f"2d-synthetic/{backend}/{name}"] = {
            "intents": [y.tobytes().hex() for y in res.intents],
            "iterations": res.n_iterations,
            "closures": res.n_closures_computed,
            "bytes": res.modeled_comm_bytes,
            "stats": {k: getattr(eng.stats, k) for k in STAT_FIELDS},
        }
cli2d = fca.cmd_mine(fca.build_parser().parse_args(
    ["mine", "--dataset", "mushroom", "--scale", "0.01", "--local-prune", "--parts", "2",
     "--cand-shards", "2", "--device", "cpu"]))
out["cli2d"] = {k: cli2d[k] for k in ("plan", "concepts", "iterations", "closures_computed",
                                      "modeled_comm_bytes", "reduce_rounds")}
trace, stats = f"trace{dist.get_rank()}.json", f"stats{dist.get_rank()}.json"
fca.main(["serve", "--dataset", "mushroom", "--scale", "0.003", "--cand-shards", "2",
          "--algorithm", "mrcbo", "--queries", "40", "--topk", "12", "--slots", "16",
          "--updates", "4", "--device", "cpu", "--trace", trace, "--stats-json", stats])
out["serve2d"] = {"trace": open(trace).read(), "stats": json.load(open(stats))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("pg"), GROUP_BODY, world=4)


@pytest.mark.parametrize("driver", list(DRIVERS))
@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("impl", IMPLS)
def test_process_group_ranks_return_the_reference_intents(jax_reference,  # noqa: F811
                                                          group_runs, impl, backend,
                                                          driver):
    want = _reference("paper", 4, impl, driver)
    simulated = _port("paper", 4, impl, driver, backend)
    assert simulated == want
    for rank, out in enumerate(group_runs):
        assert out[f"{impl}/{backend}/{driver}"] == want, f"rank {rank}"


def test_process_group_plan_geometry_and_calibration(group_runs):
    want_intents = _port("paper", 1, "rsag", "mrcbo", "torch")["intents"]
    first = group_runs[0]["calibrated"]
    for rank, out in enumerate(group_runs):
        cal = out["calibrated"]
        assert cal["hop"] == first["hop"], f"rank {rank} resolved another hop"
        assert cal["intents"] == want_intents
        assert cal["device"] == "cpu" and cal["rows"] == [256, 1]
        assert cal["describe"]["mode"] == "group" and cal["describe"]["n_parts"] == 4
        assert cal["describe"]["backend"] == "gloo"
        assert out["cuda"] in ("RuntimeError", "ValueError")


def test_cli_under_a_process_group_holds_one_shard_per_rank(group_runs):
    """``fca mine`` run by every rank of a 4-rank gloo group builds its plan
    with ``ShardPlan.auto``: one shard per rank, the default ``--parts 8``
    not read.  Counts and bytes equal ``BENCH_dist.json`` ``scaling`` at
    k = 4 under rsag, and the per-schedule round record equals the
    simulated 4-shard CLI run's."""
    (want,) = [r for r in _bench_dist()["scaling"]
               if r["plan"]["n_parts"] == 4 and r["plan"]["reduce_impl"] == "rsag"]
    simulated = fca.cmd_mine(fca.build_parser().parse_args(
        ["mine", "--dataset", "census-income", "--scale", "0.001", "--local-prune",
         "--reduce", "rsag", "--device", "cpu", "--parts", "4"]))
    assert simulated["plan"]["mode"] == "simulated"
    for rank, out in enumerate(group_runs):
        cli = out["cli"]
        assert cli["plan"]["mode"] == "group" and cli["plan"]["n_parts"] == 4, f"rank {rank}"
        assert (cli["concepts"], cli["iterations"], cli["closures_computed"],
                cli["modeled_comm_bytes"]) == (want["n_concepts"], want["n_iterations"],
                                               want["closures_computed"],
                                               want["reduce_bytes_total"]), f"rank {rank}"
        assert cli["reduce_rounds"] == simulated["reduce_rounds"], f"rank {rank}"


MESH_DRIVERS = dict(DRIVERS, **{
    "mrganter+dedupe": lambda pkg, c, e: pkg.mrganter_plus(c, e, dedupe_closures=True),
    "mrganter+iceberg": lambda pkg, c, e: pkg.mrganter_plus(c, e, local_prune=True,
                                                            min_support=6),
    "mrcbo+iceberg": lambda pkg, c, e: pkg.mrcbo(c, e, min_support=6),
})


def _reference_2d(ctx_name, impl, driver, **plan_kw) -> dict:
    """The reference on a simulated 2 x 2 (object x candidate) plan."""
    key = (ctx_name, "2x2", impl, driver, tuple(sorted(plan_kw.items())))
    if key not in _reference_runs:
        ctx = _context(ctx_name)
        plan = ref_sp.ShardPlan.simulated(2, cand_parts=2, reduce_impl=impl, **plan_kw)
        eng = ref_core.ClosureEngine(ctx, plan=plan, backend="jnp")
        _reference_runs[key] = _summary(MESH_DRIVERS[driver](ref_core, ctx, eng), eng)
    return _reference_runs[key]


def test_mesh_places_one_object_shard_and_one_block_per_rank(group_runs):
    """The 2 x 2 mesh runs the candidate axis major: ranks 0, 1 close block
    0 over object shards 0, 1; ranks 2, 3 block 1."""
    for rank, out in enumerate(group_runs):
        assert out["mesh"] == {"rank": rank, "object": rank % 2, "cand": rank // 2}


@pytest.mark.parametrize("driver", list(DRIVERS))
@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("impl", IMPLS)
def test_2d_process_group_ranks_return_the_reference_intents(jax_reference,  # noqa: F811
                                                             group_runs, impl, backend,
                                                             driver):
    """A 2 x 2 gloo mesh (object x candidate) against the reference's
    simulated 2 x 2 plan: intents in order, counts, bytes and the schedule
    census on every rank."""
    want = _reference_2d("paper", impl, driver)
    for rank, out in enumerate(group_runs):
        assert out[f"2d/{impl}/{backend}/{driver}"] == want, f"rank {rank}"


@pytest.mark.parametrize("driver", [d for d in MESH_DRIVERS if d != "mrganter"])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_2d_process_group_chunks_match_the_reference(jax_reference, group_runs,  # noqa: F811
                                                     backend, driver):
    """The synthetic context at max_batch 64: rounds span several chunks of
    two blocks, each rank closing its block at its row offset."""
    want = _reference_2d("synthetic", "rsag", driver, block_n=64, max_batch=64)
    assert want["stats"]["closure_calls"] > want["iterations"]  # several chunks a round
    for rank, out in enumerate(group_runs):
        assert out[f"2d-synthetic/{backend}/{driver}"] == want, f"rank {rank}"


def test_cli_2d_under_a_process_group_holds_one_block_per_rank(group_runs):
    """``fca mine --cand-shards 2 --parts 2`` run by the four ranks builds a
    2 x 2 mesh plan (``--parts`` not read) and mines what the simulated
    2 x 2 CLI run mines, at the same modeled bytes and schedule census."""
    args = ["mine", "--dataset", "mushroom", "--scale", "0.01", "--local-prune",
            "--parts", "2", "--cand-shards", "2", "--device", "cpu"]
    simulated = fca.cmd_mine(fca.build_parser().parse_args(args))
    assert simulated["plan"]["mode"] == "simulated" and simulated["plan"]["cand_parts"] == 2
    for rank, out in enumerate(group_runs):
        cli = out["cli2d"]
        assert cli["plan"]["mode"] == "group", f"rank {rank}"
        assert (cli["plan"]["n_parts"], cli["plan"]["cand_parts"]) == (2, 2)
        assert cli["plan"]["cand_axes"] == ["cand"] and cli["plan"]["axes"] == ["data"]
        assert cli["plan"]["mesh_shape"] == {"cand": 2, "data": 2}
        for key in ("concepts", "iterations", "closures_computed", "modeled_comm_bytes",
                    "reduce_rounds"):
            assert cli[key] == simulated[key], (rank, key)
    assert simulated["concepts"] == 4440


def test_cli_2d_serve_under_a_process_group_traces_and_writes_stats(group_runs):
    """``fca serve --cand-shards 2 --trace --stats-json`` on every rank: the
    trace validates, the stats file carries the rollup, the trace path and
    well-formed micro-batch latency percentiles."""
    from repro.obs import validate_trace as ref_validate
    from repro_torch.obs import validate_trace

    for rank, out in enumerate(group_runs):
        trace = json.loads(out["serve2d"]["trace"])
        assert validate_trace(trace)["spans"] > 0 and ref_validate(trace)
        stats = out["serve2d"]["stats"]
        assert stats["plan"]["cand_parts"] == 2 and stats["plan"]["mode"] == "group"
        assert stats["trace_path"] == f"trace{rank}.json"
        lat = stats["query_stats"]["latency_percentiles"]["micro_batch"]
        assert set(lat) == {"p50", "p95", "p99"}
        assert 0 <= lat["p50"] <= lat["p95"] <= lat["p99"]
        roll = stats["span_rollup"]
        # closure, top-k and lookup micro-batches (the order reads are not)
        assert 3 <= roll["query/micro_batch"]["count"] <= stats["query_stats"]["micro_batches"]
        for name in ("mine/mrcbo", "mine/round", "mine/round/dispatch",
                     "stream/stage", "stream/commit"):
            assert roll[name]["count"] >= 1, name


# -- the CLI -----------------------------------------------------------------


def _pruned_rsag_row() -> dict:
    (row,) = [r for r in _bench_dist()["pruning_ab"]
              if r["plan"]["reduce_impl"] == "rsag" and r["local_prune"]]
    return row


def test_cli_mines_eight_shards_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fca", "mine", "--dataset",
         "census-income", "--scale", "0.001", "--local-prune", "--parts", "8",
         "--reduce", "rsag", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout)
    want = _pruned_rsag_row()
    assert stats["plan"]["mode"] == "simulated" and stats["plan"]["n_parts"] == 8
    assert stats["plan"]["reduce_impl"] == "rsag"
    assert (stats["concepts"], stats["iterations"], stats["closures_computed"]) == (
        want["n_concepts"], want["n_iterations"], want["closures_computed"])
    assert stats["modeled_comm_bytes"] == want["reduce_bytes_total"]
    assert stats["reduce_rounds"] == {"rsag": sum(stats["reduce_rounds"].values())}


@pytest.mark.parametrize("argv", [
    ["--backend", "matmul", "--reduce", "rsag"],
    ["--reduce", "auto", "--calibrate-hops"],
])
def test_cli_backends_and_schedules(capsys, argv):
    fca.main(["mine", "--dataset", "census-income", "--scale", "0.001", "--local-prune",
              "--device", "cpu", *argv])
    stats = json.loads(capsys.readouterr().out)
    want = _pruned_rsag_row()
    assert stats["plan"]["n_parts"] == 8  # the reference CLI's default
    assert (stats["concepts"], stats["iterations"], stats["closures_computed"]) == (
        want["n_concepts"], want["n_iterations"], want["closures_computed"])
    if "auto" in argv:
        assert set(stats["reduce_rounds"]) <= {"allgather", "rsag"}
        assert stats["plan"]["auto_hop_bytes"] >= 1
    else:
        assert stats["modeled_comm_bytes"] == want["reduce_bytes_total"]
