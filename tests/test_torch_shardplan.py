"""The port's ShardPlan and object-sharded mining against the JAX package.

Plans: the simulated plan (k shards as a leading dimension on one device)
against the reference's ``ShardPlan.simulated`` — validation messages,
placement, schedule resolution, the wire-cost ledger, hop calibration;
the engine at k ∈ {1, 2, 4, 8} × {allgather, rsag, pmin, auto} × {torch,
kernel, matmul} against the reference engine (``backend="jnp"``, with the
jax-0.9 binding of the ``jax_reference`` fixture); the 4-rank gloo process group and the CLI in
``tests/test_torch_shardplan_group.py``, census-income against the
committed ``BENCH_dist.json`` in ``tests/test_torch_shardplan_census.py``
(one file each, so that the test workers take them in parallel).
Tolerance: exact equality of intents (in order), counts and bytes.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.context as ref_context
from repro.dist import shardplan as ref_sp
import repro_torch.core as core
from repro_torch.core.engine import EngineStats
from repro_torch.dist import shardplan as sp
from repro_torch.dist.shardplan import ShardPlan

from _torch_reference import jax_reference, port_context  # noqa: F401

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
