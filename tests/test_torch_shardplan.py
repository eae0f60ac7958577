"""The port's ShardPlan and object-sharded mining against the JAX package.

Plans: the simulated plan (k shards as a leading dimension on one device)
against the reference's ``ShardPlan.simulated`` — validation messages,
placement, schedule resolution, the wire-cost ledger, hop calibration;
the engine at k ∈ {1, 2, 4, 8} × {allgather, rsag, pmin, auto} × {torch,
kernel, matmul} against the reference engine (``backend="jnp"``, with the
jax-0.9 binding of the ``jax_reference`` fixture); census-income at scale
0.001 against the committed ``BENCH_dist.json``; a 4-rank gloo process
group whose ranks must all return the reference's intents; and the CLI.
Tolerance: exact equality of intents (in order), counts and bytes.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.context as ref_context
from repro.dist import shardplan as ref_sp
import repro_torch.core as core
from repro_torch.core.engine import EngineStats
from repro_torch.data import fca_datasets
from repro_torch.dist import shardplan as sp
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.launch import fca

from _torch_reference import jax_reference, port_context  # noqa: F401
from test_torch_collectives import run_ranks

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
IMPLS = ["allgather", "rsag", "pmin", "auto"]
STAT_FIELDS = [
    f.name for f in dataclasses.fields(EngineStats) if f.type in ("int", "dict")
]
DRIVERS = {
    "mrganter": lambda pkg, c, e: pkg.mrganter(c, e),
    "mrganter+": lambda pkg, c, e: pkg.mrganter_plus(c, e, dedupe_candidates=True),
    "mrcbo": lambda pkg, c, e: pkg.mrcbo(c, e),
}
CONTEXTS = {
    "paper": ref_context.paper_context,
    "synthetic": lambda: ref_context.FormalContext.synthetic(60, 24, 0.35, seed=42),
}
_contexts: dict = {}
_reference_runs: dict = {}


def _context(name):
    if name not in _contexts:
        _contexts[name] = CONTEXTS[name]()
    return _contexts[name]


def _summary(res, eng) -> dict:
    return {
        "intents": [np.asarray(y, np.uint32).tobytes().hex() for y in res.intents],
        "iterations": res.n_iterations,
        "closures": res.n_closures_computed,
        "bytes": res.modeled_comm_bytes,
        "stats": {k: getattr(eng.stats, k) for k in STAT_FIELDS},
    }


def _reference(ctx_name, k, impl, driver, hop=None) -> dict:
    key = (ctx_name, k, impl, driver, hop)
    if key not in _reference_runs:
        ctx = _context(ctx_name)
        plan = ref_sp.ShardPlan.simulated(k, reduce_impl=impl)
        if hop is not None:
            plan = dataclasses.replace(plan, auto_hop_bytes=hop, hop_calibrated=True)
        eng = ref_core.ClosureEngine(ctx, plan=plan, backend="jnp")
        _reference_runs[key] = _summary(DRIVERS[driver](ref_core, ctx, eng), eng)
    return _reference_runs[key]


def _port(ctx_name, k, impl, driver, backend, plan=None) -> dict:
    ctx = port_context(_context(ctx_name))
    if plan is None:
        eng = core.ClosureEngine(ctx, n_parts=k, reduce_impl=impl, backend=backend,
                                 device="cpu")
    else:
        eng = core.ClosureEngine(ctx, plan=plan, backend=backend, device="cpu")
    return _summary(DRIVERS[driver](core, ctx, eng), eng)


# -- validation and geometry -------------------------------------------------


def _message(fn) -> tuple[type, str]:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e), str(e)
    return None, ""


@pytest.mark.parametrize(
    "case",
    ["unknown-schedule", "unknown-auto-spelling", "n_parts-0", "cand_parts-0",
     "rows-not-divisible"],
)
def test_plan_validation_matches_reference(case):
    build = {
        "unknown-schedule": lambda m: m.ShardPlan.simulated(2, reduce_impl="morse-code"),
        "unknown-auto-spelling": lambda m: m.ShardPlan.simulated(4, reduce_impl="autotune"),
        "n_parts-0": lambda m: m.ShardPlan.simulated(0),
        "cand_parts-0": lambda m: m.ShardPlan.simulated(2, cand_parts=0),
        "rows-not-divisible": lambda m: m.ShardPlan.simulated(3).place_rows(
            np.zeros((7, 2), np.uint32), *([CPU] if m is sp else [])),
    }[case]
    want = _message(lambda: build(ref_sp))
    got = _message(lambda: build(sp))
    assert want[0] is ValueError
    assert got == want


def test_multi_shard_plans_raise():
    """Multi-shard plans run, 2-D ones with the reference's geometry; what
    the port refuses raises."""
    assert ShardPlan(n_parts=2).n_parts == 2
    plan, ref = ShardPlan.simulated(2, cand_parts=2), ref_sp.ShardPlan.simulated(2, cand_parts=2)
    assert (plan.n_parts, plan.cand_parts, plan.cand_axes, plan.row_alignment) == (
        ref.n_parts, ref.cand_parts, ref.cand_axes, ref.row_alignment)
    assert plan.describe() == {**ref.describe(), "mode": "simulated", "backend": None}
    # out_shard= is ported now; with post= it raises, as in the reference
    with pytest.raises(ValueError, match="mutually exclusive"):
        ShardPlan.simulated(2).spmd(lambda r: (r,), n_rep=0, post=lambda r: r,
                                    out_shard=(True,))
    with pytest.raises(ValueError):
        core.ClosureEngine(core.paper_context(), device="cpu", backend="jnp")
    with pytest.raises(RuntimeError, match="initialized"):
        ShardPlan.over_group(None, "cpu")


def test_simulated_geometry_matches_reference():
    plan = ShardPlan.simulated(4, reduce_impl="allgather", block_n=64)
    ref = ref_sp.ShardPlan.simulated(4, reduce_impl="allgather", block_n=64)
    assert plan.is_simulated and plan.reduce_axes == ref.reduce_axes == sp.SIM_AXIS
    assert plan.row_alignment == ref.row_alignment == 256
    rows = np.arange(4 * 64 * 2 * 3, dtype=np.uint32).reshape(-1, 3)
    rows[::5, 1] |= np.uint32(1 << 31)
    placed = plan.place_rows(rows, CPU)
    assert placed.shape == (4, 128, 3) and placed.dtype == torch.int32
    np.testing.assert_array_equal(placed.numpy().view(np.uint32),
                                  np.asarray(ref.place_rows(rows)))
    desc, ref_desc = plan.describe(), ref.describe()
    shared = set(desc) & set(ref_desc)
    assert {"mode", "n_parts", "axes", "reduce_impl", "block_n", "max_batch",
            "auto_hop_bytes", "hop_calibrated", "cand_parts"} <= shared
    assert {k: desc[k] for k in shared} == {k: ref_desc[k] for k in shared}
    gens = np.array([-1, 3], np.int32)
    assert plan.replicate(gens, CPU).tolist() == [-1, 3]


def test_auto_plan_without_a_group_is_simulated():
    plan = ShardPlan.auto(n_parts=5)
    assert plan.is_simulated and plan.n_parts == 5


def test_engine_geometry_knobs_match_reference():
    ctx = _context("paper")
    for pkg, kw in ((ref_core, {}), (core, {"device": "cpu"})):
        plan = (ref_sp if pkg is ref_core else sp).ShardPlan.simulated(2)
        with pytest.raises(ValueError, match="not both"):
            pkg.ClosureEngine(ctx if pkg is ref_core else port_context(ctx), plan=plan,
                              n_parts=2, **kw)
    eng = core.ClosureEngine(port_context(ctx), plan=ShardPlan.simulated(2), device="cpu",
                             reduce_impl="pmin", block_n=64, max_batch=512)
    ref = ref_core.ClosureEngine(ctx, plan=ref_sp.ShardPlan.simulated(2), backend="jnp",
                                 reduce_impl="pmin", block_n=64, max_batch=512)
    assert (eng.plan.reduce_impl, eng.block_n, eng.max_batch, eng.n_parts) == (
        ref.plan.reduce_impl, ref.block_n, ref.max_batch, ref.n_parts)
    assert (eng.n_pad_rows, eng.N_padded, eng.min_bucket) == (
        ref.n_pad_rows, ref.N_padded, ref.min_bucket)
    assert tuple(eng.rows.shape) == tuple(ref.rows.shape)


# -- the wire-cost ledger and the auto schedule ------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_resolution_and_ledger_match_reference(k):
    for impl in IMPLS:
        for hop in (0, 1, 4096, 1 << 20):
            plan = dataclasses.replace(ShardPlan.simulated(k, reduce_impl=impl),
                                       auto_hop_bytes=hop)
            ref = dataclasses.replace(ref_sp.ShardPlan.simulated(k, reduce_impl=impl),
                                      auto_hop_bytes=hop)
            for batch in (1, 8, 64, 512, 4096, 8192, 32768):
                for W, n_attrs in ((1, 24), (4, 125), (5, 133), (3, None)):
                    assert plan.resolve_impl(batch, W, n_attrs) == \
                        ref.resolve_impl(batch, W, n_attrs)
                    assert plan.modeled_reduce_bytes(batch, W, n_attrs) == \
                        ref.modeled_reduce_bytes(batch, W, n_attrs)
                    assert plan.modeled_latency_split(batch, W, n_attrs) == \
                        ref.modeled_latency_split(batch, W, n_attrs)


def test_hop_probe_measures_and_caches():
    sp._HOP_PROBE_CACHE.clear()
    plan = ShardPlan.simulated(4, calibrate_hops=True, device="cpu")
    if plan.hop_calibrated:
        assert 1 <= plan.auto_hop_bytes <= 1 << 24
    else:
        assert plan.auto_hop_bytes == 4096
    assert plan.describe()["hop_calibrated"] == plan.hop_calibrated
    assert plan.describe()["auto_hop_bytes"] == plan.auto_hop_bytes
    key = next(iter(sp._HOP_PROBE_CACHE))
    sp._HOP_PROBE_CACHE[key] = (12345, True)
    cached = ShardPlan.simulated(4, calibrate_hops=True, device="cpu")
    assert cached.auto_hop_bytes == 12345 and cached.hop_calibrated
    sp._HOP_PROBE_CACHE.clear()
    assert ShardPlan.simulated(4).auto_hop_bytes == 4096
    assert not ShardPlan.simulated(4).hop_calibrated


def test_hop_probe_noise_floor_keeps_the_default(monkeypatch):
    sp._HOP_PROBE_CACHE.clear()
    monkeypatch.setattr(sp.time, "perf_counter", lambda: 1.0)  # no measurable slope
    plan = ShardPlan.simulated(8, calibrate_hops=True, device="cpu")
    assert (plan.auto_hop_bytes, plan.hop_calibrated) == (4096, False)
    sp._HOP_PROBE_CACHE.clear()


@pytest.mark.parametrize("hop", ["calibrated", 1 << 20])
def test_auto_with_a_calibrated_hop_matches_reference(jax_reference, hop):  # noqa: F811
    driver = "mrganter+"
    sp._HOP_PROBE_CACHE.clear()
    plan = ShardPlan.simulated(8, reduce_impl="auto", calibrate_hops=True, device="cpu")
    sp._HOP_PROBE_CACHE.clear()
    if hop != "calibrated":
        plan = dataclasses.replace(plan, auto_hop_bytes=hop, hop_calibrated=True)
    want = _reference("synthetic", 8, "auto", driver, hop=plan.auto_hop_bytes)
    got = _port("synthetic", 8, "auto", driver, "kernel", plan=plan)
    assert got["intents"] == want["intents"]
    assert (got["iterations"], got["closures"], got["bytes"]) == (
        want["iterations"], want["closures"], want["bytes"])
    assert got["stats"] == want["stats"]
    assert sum(got["stats"]["reduce_rounds"].values()) == got["stats"]["closure_calls"]


# -- the engine over simulated shards ----------------------------------------


@pytest.mark.parametrize("backend", ["torch", "kernel", "matmul"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_engine_matches_reference_on_the_paper_context(jax_reference, k, impl,  # noqa: F811
                                                       backend):
    for driver in DRIVERS:
        want = _reference("paper", k, impl, driver)
        got = _port("paper", k, impl, driver, backend)
        assert got == want, driver
        assert len(got["intents"]) == 21


SYNTHETIC_CASES = [
    # (k, impl, backend, driver): 1751 concepts; 1751 / 7 / 8 iterations
    (2, "allgather", "kernel", "mrganter+"),
    (2, "pmin", "kernel", "mrcbo"),
    (4, "rsag", "kernel", "mrganter"),
    (4, "auto", "matmul", "mrganter+"),
    (8, "rsag", "kernel", "mrganter+"),
    (8, "auto", "kernel", "mrcbo"),
]


@pytest.mark.parametrize("k,impl,backend,driver", SYNTHETIC_CASES)
def test_engine_matches_reference_on_the_synthetic_context(jax_reference, k,  # noqa: F811
                                                           impl, backend, driver):
    want = _reference("synthetic", k, impl, driver)
    got = _port("synthetic", k, impl, driver, backend)
    assert got == want
    assert len(got["intents"]) == 1751
    assert got["iterations"] == {"mrganter": 1751, "mrganter+": 7, "mrcbo": 8}[driver]


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
