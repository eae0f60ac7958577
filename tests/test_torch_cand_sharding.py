"""2-D (candidate × object) sharding of the port against the JAX package.

The plan's candidate axis: geometry, ``spmd_cand`` blocking and gathering
(and its degenerate one-block case), the 2-D wire and latency model, the
frontier's round budget, the block merges on seeded stacks, the three
drivers on simulated 2-D plans at chunk sizes small enough that a round
spans several chunks (both pipelines, closure dedupe, iceberg), the
committed ``BENCH_dist.json`` 2-D rows, the ``fca --cand-shards`` JSON and
a hypothesis property.  The reference runs ``backend="jnp"`` under the
jax-0.9 binding of the ``jax_reference`` fixture; the port runs on the CPU
with the kernels' plain versions.  Tolerance: exact equality of intents
(in order), counts, bytes and schedule census.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as ref_core
import repro.core.context as ref_context
from repro.core import frontier as ref_frontier
from repro.data import fca_datasets as ref_datasets
from repro.dist import shardplan as ref_sp
from repro.launch import fca as ref_fca
import repro_torch.core as core
from repro_torch.core import frontier as port_frontier
from repro_torch.core.engine import EngineStats
from repro_torch.data import fca_datasets
from repro_torch.dist import collectives
from repro_torch.dist import shardplan as sp
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.launch import fca

from _torch_reference import jax_reference, port_context, t, u32  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
IMPLS = ["allgather", "rsag", "pmin", "auto"]
GEOMETRIES = [(1, 2), (1, 8), (2, 2), (4, 2), (2, 4)]  # n_parts x cand_parts
STAT_FIELDS = [f.name for f in dataclasses.fields(EngineStats) if f.type in ("int", "dict")]
CONTEXTS = {
    "paper": ref_context.paper_context,
    "synthetic": lambda: ref_context.FormalContext.synthetic(60, 24, 0.35, seed=42),
    "mushroom-0.01": lambda: ref_datasets.load("mushroom", scale=0.01)[0],
}
# (n_parts, cand_parts, reduce_impl, block_n, max_batch) per context: small
# chunks, so that a round spans several chunks of several blocks
PLANS = {
    "paper": (2, 2, "rsag", 64, 2),
    "synthetic": (2, 4, "auto", 64, 16),
    "mushroom-0.01": (4, 2, "rsag", 256, 4096),
}
MIN_SUPPORT = {"paper": 2, "synthetic": 6, "mushroom-0.01": 8}
DRIVERS = {
    "mrganter": lambda pkg, c, e, **kw: pkg.mrganter(c, e, **kw),
    "mrganter+": lambda pkg, c, e, **kw: pkg.mrganter_plus(c, e, local_prune=True, **kw),
    "mrganter+dedupe": lambda pkg, c, e, **kw: pkg.mrganter_plus(
        c, e, dedupe_candidates=True, dedupe_closures=True, **kw),
    "mrcbo": lambda pkg, c, e, **kw: pkg.mrcbo(c, e, **kw),
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


def _plan_kw(name):
    k, c, impl, block_n, max_batch = PLANS[name]
    return k, dict(cand_parts=c, reduce_impl=impl, block_n=block_n, max_batch=max_batch)


def _run(pkg, name, driver, pipeline, iceberg):
    k, kw = _plan_kw(name)
    ref = pkg is ref_core
    ctx = _context(name) if ref else port_context(_context(name))
    plan = (ref_sp if ref else sp).ShardPlan.simulated(k, **kw)
    if ref:
        eng = ref_core.ClosureEngine(ctx, plan=plan, backend="jnp")
    else:
        eng = core.ClosureEngine(ctx, plan=plan, backend="kernel", device="cpu")
    ms = MIN_SUPPORT[name] if iceberg else None
    return _summary(DRIVERS[driver](pkg, ctx, eng, pipeline=pipeline, min_support=ms), eng)


def _reference(name, driver, pipeline, iceberg):
    key = (name, driver, pipeline, iceberg)
    if key not in _reference_runs:
        _reference_runs[key] = _run(ref_core, name, driver, pipeline, iceberg)
    return _reference_runs[key]


# -- geometry ----------------------------------------------------------------


def test_cand_geometry_matches_reference():
    plan = ShardPlan.simulated(4, cand_parts=3, block_n=64)
    ref = ref_sp.ShardPlan.simulated(4, cand_parts=3, block_n=64)
    assert plan.cand_parts == ref.cand_parts == 3
    assert plan.cand_axes == ref.cand_axes == sp.SIM_CAND_AXIS
    assert plan.cand_index() == 0
    one, ref_one = ShardPlan.simulated(4), ref_sp.ShardPlan.simulated(4)
    assert one.cand_axes is None and ref_one.cand_axes is None
    for p, r in ((plan, ref), (one, ref_one)):
        desc, want = p.describe(), r.describe()
        assert set(want) <= set(desc)
        assert {key: desc[key] for key in want} == want
        assert p.trace_tags() == r.trace_tags()


def test_round_budget_scales_with_cand_parts():
    ctx = port_context(_context("synthetic"))
    for c in (1, 2, 4):
        plan = ShardPlan.simulated(2, cand_parts=c, block_n=64, max_batch=128)
        fr = core.DeviceFrontier(core.ClosureEngine(ctx, plan=plan, device="cpu"))
        ref_plan = ref_sp.ShardPlan.simulated(2, cand_parts=c, block_n=64, max_batch=128)
        ref_fr = ref_core.DeviceFrontier(ref_core.ClosureEngine(_context("synthetic"),
                                                                plan=ref_plan, backend="jnp"))
        assert fr.round_budget == ref_fr.round_budget == 128 * c
        for b in (1, 7, 8, 9, 127, 128, 129, 255, 256, 1000):
            assert fr._chunk_caps(b) == ref_fr._chunk_caps(b)
            if c > 1:
                assert fr._block_cap(b) == ref_fr._block_cap(b)


def _spmd_cand_case(plan, rows, cands, n_valid):
    def body(rows_local, cb):
        return collectives.and_allreduce(rows_local[..., :1, :] & cb, plan.reduce_axes,
                                         impl="rsag")

    def post(idx, gc, n_valid):
        valid = (torch.arange(gc.shape[1])[None, :] + idx[:, None] * gc.shape[1]) < n_valid
        return torch.where(valid[..., None], gc, 0), valid.sum(-1, dtype=torch.int32)

    fn = plan.spmd_cand(body, n_cand=1, post=post, n_post_rep=1)
    return fn(plan.place_rows(rows, "cpu"), t(cands), n_valid)


def test_spmd_cand_blocks_and_gathers():
    """Candidate operands are blocked, the object reduce runs per block, and
    outputs come back as [cand_parts, ...] stacks ready to merge."""
    plan = ShardPlan.simulated(2, cand_parts=3, block_n=4)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 1 << 32, size=(16, 3), dtype=np.uint32)
    cands = rng.integers(0, 1 << 32, size=(12, 3), dtype=np.uint32)
    gcs, counts = _spmd_cand_case(plan, rows, cands, 10)
    assert tuple(gcs.shape) == (3, 4, 3) and tuple(counts.shape) == (3,)
    want = (rows[0] & cands) & (rows[8] & cands)
    want[10:] = 0
    np.testing.assert_array_equal(u32(gcs).reshape(12, 3), want)
    assert counts.tolist() == [4, 4, 2]


def test_spmd_cand_degenerates_at_one_block():
    """cand_parts == 1 gives a length-1 stack, bit-identical to the
    multi-block result."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 1 << 32, size=(16, 3), dtype=np.uint32)
    cands = rng.integers(0, 1 << 32, size=(12, 3), dtype=np.uint32)
    outs = []
    for c in (1, 3):
        plan = ShardPlan.simulated(2, cand_parts=c, block_n=4)
        assert (plan.cand_parts == 1) == (plan.cand_axes is None)
        gcs, counts = _spmd_cand_case(plan, rows, cands, 10)
        assert gcs.shape[0] == c and int(counts.sum()) == 10
        outs.append(u32(gcs).reshape(12, 3))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_hop_probe_cache_keys_on_cand_geometry():
    """A calibrated hop value never leaks between plans of another
    geometry: the same object shard count with candidate blocks gets a
    fresh probe, the same geometry reads its cache (the reference's
    ``test_hop_probe_cache_keys_on_cand_geometry``)."""
    sp._HOP_PROBE_CACHE.clear()
    try:
        ShardPlan.simulated(4, calibrate_hops=True, device="cpu")
        assert len(sp._HOP_PROBE_CACHE) == 1
        key = next(iter(sp._HOP_PROBE_CACHE))
        sp._HOP_PROBE_CACHE[key] = (999_999, True)  # poison the 4 x 1 entry
        plan2 = ShardPlan.simulated(4, cand_parts=2, calibrate_hops=True, device="cpu")
        assert plan2.auto_hop_bytes != 999_999 and len(sp._HOP_PROBE_CACHE) == 2
        assert ShardPlan.simulated(4, calibrate_hops=True, device="cpu").auto_hop_bytes == 999_999
    finally:
        sp._HOP_PROBE_CACHE.clear()


# -- the 2-D wire and latency model ------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k,c", GEOMETRIES)
def test_cand_byte_model_matches_reference(k, c, impl):
    for hop in (1, 4096, 1 << 20):
        plan = dataclasses.replace(ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl),
                                   auto_hop_bytes=hop)
        ref = dataclasses.replace(ref_sp.ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl),
                                  auto_hop_bytes=hop)
        desc = plan.describe()
        assert {key: desc[key] for key in ref.describe()} == ref.describe()
        assert plan.trace_tags() == ref.trace_tags()
        for blk in (1, 8, 64, 512, 4096, 8192):
            for W, n_attrs in ((1, 24), (4, 125), (5, 133), (3, None)):
                assert plan.modeled_round_bytes_cand(blk, W, n_attrs) == \
                    ref.modeled_round_bytes_cand(blk, W, n_attrs)
                assert plan.modeled_latency_split_cand(blk, W, n_attrs) == \
                    ref.modeled_latency_split_cand(blk, W, n_attrs)
                assert plan.resolve_impl(blk, W, n_attrs) == ref.resolve_impl(blk, W, n_attrs)


def test_cand_round_bytes_degenerate_to_the_1d_model():
    one = ShardPlan.simulated(4, reduce_impl="rsag")
    assert one.modeled_round_bytes_cand(128, 3, 70) == one.modeled_reduce_bytes(128, 3, 70)
    assert one.modeled_latency_split_cand(128, 3, 70) == one.modeled_latency_split(128, 3, 70)


# -- block merges --------------------------------------------------------------


def _stacks(seed, c=4, Bc=16, W=3):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, size=(7, W), dtype=np.uint32)
    pool[0, 0] |= np.uint32(1 << 31)
    gc = pool[rng.integers(0, 7, size=(c, Bc))]  # duplicates within and across blocks
    gens = rng.integers(0, 40, size=(c, Bc)).astype(np.int32)
    counts = rng.integers(0, Bc + 1, size=(c,)).astype(np.int32)
    counts[0] = Bc
    return gc, gens, counts


@pytest.mark.parametrize("seed", range(4))
def test_block_merges_match_reference(seed):
    gc, gens, counts = _stacks(seed)
    n, c, Bc = int(counts.sum()), *gc.shape[:2]
    np.testing.assert_array_equal(u32(port_frontier.merge_blocks_plain(t(gc))),
                                  u32(ref_frontier.merge_blocks_plain(jnp.asarray(gc))))
    np.testing.assert_array_equal(
        port_frontier._block_valid(torch.from_numpy(counts), Bc).numpy(),
        np.asarray(ref_frontier._block_valid(jnp.asarray(counts), Bc)))
    for name in ("merge_blocks_compact", "merge_blocks_unique"):
        got_gc, got_n = getattr(port_frontier, name)(t(gc), torch.from_numpy(counts))
        want_gc, want_n = getattr(ref_frontier, name)(jnp.asarray(gc), jnp.asarray(counts))
        assert int(got_n) == int(want_n) <= n, name
        np.testing.assert_array_equal(u32(got_gc), u32(want_gc), err_msg=name)
    got = port_frontier.merge_blocks_cbo(t(gc), torch.from_numpy(gens), torch.from_numpy(counts))
    want = ref_frontier.merge_blocks_cbo(jnp.asarray(gc), jnp.asarray(gens),
                                         jnp.asarray(counts))
    assert int(got[2]) == int(want[2]) == n
    np.testing.assert_array_equal(u32(got[0]), u32(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("seed", range(4))
def test_block_local_compaction_equals_per_block_compaction(seed):
    """The batched block filters give each block what the 1-D compaction
    and sorted-unique give it alone — rows past the count included."""
    gc, gens, _ = _stacks(seed)
    keep = np.random.default_rng(seed + 10).random(gc.shape[:2]) < 0.6
    counts, got_gc, got_g = port_frontier._compact_blocks(torch.from_numpy(keep), t(gc),
                                                          torch.from_numpy(gens))
    ucounts, ugc, ug = port_frontier._sort_unique_blocks(t(gc), torch.from_numpy(keep),
                                                         torch.from_numpy(gens))
    for i in range(gc.shape[0]):
        n, c1, g1 = port_frontier._compact(torch.from_numpy(keep[i]), t(gc[i]),
                                           torch.from_numpy(gens[i]))
        assert int(counts[i]) == int(n)
        np.testing.assert_array_equal(u32(got_gc[i]), u32(c1))
        np.testing.assert_array_equal(got_g[i].numpy(), g1.numpy())
        n, c2, g2 = port_frontier._sort_unique(t(gc[i]), torch.from_numpy(keep[i]),
                                               torch.from_numpy(gens[i]))
        rn, rc, rg = ref_frontier._sort_unique(jnp.asarray(gc[i]), jnp.asarray(keep[i]),
                                               jnp.asarray(gens[i]))
        assert int(ucounts[i]) == int(n) == int(rn)
        np.testing.assert_array_equal(u32(ugc[i])[: int(n)], u32(c2)[: int(n)])
        np.testing.assert_array_equal(u32(ugc[i])[: int(n)], u32(rc)[: int(n)])
        np.testing.assert_array_equal(ug[i].numpy()[: int(n)], np.asarray(rg)[: int(n)])


# -- mining on 2-D plans ----------------------------------------------------------


def _cases():
    for name in ("paper", "synthetic"):
        for driver in DRIVERS:
            for pipeline in ("device", "host"):
                if pipeline == "host" and driver == "mrganter+dedupe":
                    continue  # closure dedupe is a device-pipeline stage
                for iceberg in (False, True):
                    if name == "synthetic" and driver == "mrganter" and (
                            pipeline, iceberg) != ("device", True):
                        continue  # a 1751-round walk of 1-D steps; paper covers them
                    yield name, driver, pipeline, iceberg
    # MRGanter+ with local pruning at 4 x 2: test_cli_cand_shards_matches_reference_cli
    yield "mushroom-0.01", "mrcbo", "device", False
    yield "mushroom-0.01", "mrganter+dedupe", "device", True


@pytest.mark.parametrize("name,driver,pipeline,iceberg", list(_cases()))
def test_driver_on_a_2d_plan_matches_reference(jax_reference, name, driver,  # noqa: F811
                                               pipeline, iceberg):
    want = _reference(name, driver, pipeline, iceberg)
    got = _run(core, name, driver, pipeline, iceberg)
    assert got == want
    assert sum(got["stats"]["reduce_rounds"].values()) == got["stats"]["closure_calls"]
    if pipeline == "device" and driver != "mrganter" and name != "mushroom-0.01":
        # a round spanned several chunks
        assert got["stats"]["closure_calls"] > got["iterations"]


def test_adopt_refuses_to_drop_rows_and_names_cand_shards():
    eng = core.ClosureEngine(port_context(_context("paper")), device="cpu")
    fr = core.DeviceFrontier(eng)
    with pytest.raises(RuntimeError, match="cand-shards"):
        fr._adopt(torch.zeros((4, 1), dtype=torch.int32), None, 9)


# -- the committed benchmark rows ----------------------------------------------


def _bench_dist() -> dict:
    return json.loads((ROOT / "BENCH_dist.json").read_text())


@pytest.mark.parametrize("row", range(3))
def test_cand2d_ab_matches_bench_dist(row):
    """BENCH_dist.json ``cand2d_ab``: census-income at scale 0.001, MRGanter+
    with local pruning, rsag, max_batch 1024, on 8 x 1, 4 x 2 and 2 x 4;
    and ``headline_2d``: 1,515,840 B per round at 8 x 1 against 898,240 at
    2 x 4."""
    want = _bench_dist()["cand2d_ab"][row]
    ctx, _ = fca_datasets.load("census-income", scale=0.001, seed=0)
    p = want["plan"]
    plan = ShardPlan.simulated(p["n_parts"], cand_parts=p["cand_parts"],
                               reduce_impl=p["reduce_impl"], max_batch=p["max_batch"])
    eng = core.ClosureEngine(ctx, plan=plan, backend="kernel", device="cpu")
    res = core.mrganter_plus(ctx, eng, local_prune=True)
    rounds = max(1, eng.stats.rounds)
    got = {"n_concepts": res.n_concepts, "n_iterations": res.n_iterations,
           "closures_computed": eng.stats.closures_computed, "rounds": rounds,
           "reduce_bytes_total": eng.stats.modeled_comm_bytes,
           "reduce_bytes_per_round": eng.stats.modeled_comm_bytes // rounds}
    assert got == {k: want[k] for k in got}
    desc = eng.plan.describe()
    assert {k: desc[k] for k in p} == p
    head = _bench_dist()["headline_2d"]
    if (p["n_parts"], p["cand_parts"]) == (8, 1):
        assert got["reduce_bytes_per_round"] == head["reduce_bytes_per_round_1d"] == 1_515_840
    if (p["n_parts"], p["cand_parts"]) == (2, 4):
        assert got["reduce_bytes_per_round"] == head["reduce_bytes_per_round_2d"] == 898_240


# -- the CLI -------------------------------------------------------------------


def test_cli_cand_shards_matches_reference_cli(jax_reference, capsys):  # noqa: F811
    """``fca mine --cand-shards 2 --parts 4`` on mushroom 0.01: the JSON
    equals the reference CLI's on the shared keys, the plan's ``cand_axes``
    and ``mesh_shape`` included (walls excepted)."""
    argv = ["mine", "--dataset", "mushroom", "--scale", "0.01", "--parts", "4",
            "--cand-shards", "2", "--local-prune"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_fca.main(argv + ["--backend", "jnp"])
    want = json.loads(buf.getvalue())
    fca.main(argv + ["--no-kernel", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    walls = {"wall_time_s", "dispatch_s", "host_blocked_s"}
    shared = (set(want) & set(got)) - walls
    assert {"plan", "concepts", "iterations", "closures_computed", "modeled_comm_bytes",
            "reduce_rounds", "rounds", "pipeline"} <= shared
    assert {k: got[k] for k in shared if k not in ("plan", "backend")} == {
        k: want[k] for k in shared if k not in ("plan", "backend")}
    assert {k: got["plan"][k] for k in want["plan"]} == want["plan"]
    assert got["plan"]["cand_axes"] == ["candpart"] and got["plan"]["mesh_shape"] is None
    assert got["backend"] == "torch"
    # the concept identity of the reference CI's --cand-shards smoke: the
    # 1-D run's 4440 concepts in its 7 iterations
    assert (got["concepts"], got["iterations"]) == (4440, 7)


# -- property -----------------------------------------------------------------


@settings(deadline=None, max_examples=8, derandomize=True)
@given(st.integers(8, 50), st.integers(3, 18), st.floats(0.15, 0.5),
       st.integers(0, 10_000), st.integers(1, 3), st.integers(1, 3))
def test_property_cand_sharded_equals_host(n, m, density, seed, n_parts, cp):
    """Any 2-D plan mines the host pipeline's concept set, MRGanter+ and
    MRCbo, through the kernel backend's 2-D steps."""
    ctx = port_context(ref_context.FormalContext.synthetic(n, m, density, seed=seed))
    plan = ShardPlan.simulated(n_parts, cand_parts=cp, block_n=64, max_batch=32)

    def keys(res):
        return {y.tobytes() for y in res.intents}

    for drive in (lambda c, e, p: core.mrganter_plus(c, e, pipeline=p, dedupe_candidates=True),
                  lambda c, e, p: core.mrcbo(c, e, pipeline=p)):
        host = drive(ctx, core.ClosureEngine(ctx, n_parts=n_parts, block_n=64, device="cpu"),
                     "host")
        dev = drive(ctx, core.ClosureEngine(ctx, plan=plan, device="cpu"), "device")
        assert keys(host) == keys(dev)
