"""Async (speculative) rounds of the port against the JAX package.

``rounds="async"`` dispatches round r+1 against round r's survivor buffer
while its count is still on the device, and reconciles round r once
round r+1 is in flight.  Mirrors tests/test_async_rounds.py with both
packages on the same inputs: the three drivers on 1-D and 2-D simulated
plans, iceberg or not, on both the port's backends (the kernels' plain
versions on the CPU); the reconciliation edge cases (an exact round-budget
boundary, over-expansion falling back, a tiny budget, an empty frontier
after a speculative iceberg round, the all-ones context, ``len()`` while
speculative, the ``_adopt`` guard, ``max_iterations``); K2's and K4's
plain versions with the count as an int and as a 0-dim tensor; a 2-rank
gloo group; and ``fca mine --rounds async --trace``.  The reference runs
``backend="jnp"`` under the jax-0.9 binding of the ``jax_reference``
fixture.  Tolerance: exact equality of intents (in order), iteration
counts, the speculation census, rounds, closures, modeled bytes and the
transfer census; the port's own sync run gives the same concept set and
iteration count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.context as ref_context
from repro.dist import shardplan as ref_sp
from repro.launch import fca as ref_fca
import repro_torch.core as core
from repro_torch.core.engine import EngineStats
from repro_torch.dist import shardplan as sp
from repro_torch.kernels import frontier as fk
from repro_torch.kernels.ops import bucket_size
from repro_torch.launch import fca
from repro_torch.obs import async_overlaps, validate_trace
from repro_torch.obs import trace as obs_trace

from _torch_reference import jax_reference, port_context, random_bits, t  # noqa: F401
from test_torch_collectives import run_ranks

STAT_FIELDS = [f.name for f in dataclasses.fields(EngineStats) if f.type in ("int", "dict")]
SPEC_FIELDS = ("spec_rounds", "spec_fallbacks", "spec_discarded")
GEOMETRIES = [(1, 1), (3, 1), (2, 2)]  # object shards x candidate blocks
DRIVERS = {
    "mrganter+": lambda pkg, c, e, **kw: pkg.mrganter_plus(c, e, local_prune=True, **kw),
    "mrcbo": lambda pkg, c, e, **kw: pkg.mrcbo(c, e, **kw),
    "mrganter": lambda pkg, c, e, **kw: pkg.mrganter(c, e, **kw),
}
CONTEXTS = {
    "synthetic": lambda: ref_context.FormalContext.synthetic(90, 21, 0.25, seed=7),
    # small enough for MRGanter's one-concept-per-round walk to finish
    "small": lambda: ref_context.FormalContext.synthetic(60, 12, 0.3, seed=3),
    "all-ones": lambda: ref_context.FormalContext.synthetic(20, 6, 1.0, seed=0),
}
_contexts: dict = {}
_reference_runs: dict = {}


def _context(name, port: bool = False):
    if name not in _contexts:
        ref = CONTEXTS[name]()
        _contexts[name] = (ref, port_context(ref))
    return _contexts[name][port]


def _plans(geom, **kw):
    k, c = geom
    return (ref_sp.ShardPlan.simulated(k, cand_parts=c, block_n=64, **kw),
            sp.ShardPlan.simulated(k, cand_parts=c, block_n=64, **kw))


def _summary(res, eng) -> dict:
    return {
        "intents": [np.asarray(y, np.uint32).tobytes().hex() for y in res.intents],
        "iterations": res.n_iterations,
        "closures": res.n_closures_computed,
        "bytes": res.modeled_comm_bytes,
        "stats": {k: getattr(eng.stats, k) for k in STAT_FIELDS},
    }


def _reference(ctx_name, driver, geom, rounds="async", **kw) -> dict:
    """The reference's run, memoized per case."""
    key = (ctx_name, driver, geom, rounds, tuple(sorted(kw.items())))
    if key not in _reference_runs:
        ctx = _context(ctx_name)
        plan_kw = {"max_batch": kw.pop("max_batch")} if "max_batch" in kw else {}
        eng = ref_core.ClosureEngine(ctx, plan=_plans(geom, **plan_kw)[0], backend="jnp")
        res = DRIVERS[driver](ref_core, ctx, eng, rounds=rounds, **kw)
        _reference_runs[key] = _summary(res, eng)
    return _reference_runs[key]


def _port(ctx_name, driver, geom, rounds="async", backend="kernel", **kw) -> dict:
    ctx = _context(ctx_name, port=True)
    plan_kw = {"max_batch": kw.pop("max_batch")} if "max_batch" in kw else {}
    eng = core.ClosureEngine(ctx, plan=_plans(geom, **plan_kw)[1], backend=backend,
                             device="cpu")
    return _summary(DRIVERS[driver](core, ctx, eng, rounds=rounds, **kw), eng)


def _same_lattice(a: dict, b: dict) -> bool:
    return set(a["intents"]) == set(b["intents"]) and a["iterations"] == b["iterations"]


# -- the grid: every driver x plan geometry x threshold x backend --------------


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("min_support", [None, 4])
@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("driver", list(DRIVERS))
def test_async_matches_reference_and_sync(jax_reference, driver, geom,  # noqa: F811
                                          min_support, backend):
    # MRGanter's one-concept-per-round walk capped, as the reference's grid does
    kw = {"max_iterations": 40} if driver == "mrganter" else {}
    want = _reference("synthetic", driver, geom, min_support=min_support, **kw)
    got = _port("synthetic", driver, geom, backend=backend, min_support=min_support, **kw)
    assert got == want
    assert got["stats"]["spec_rounds"] > 0
    if not kw:  # an uncapped run's last speculative round is always discarded
        assert got["stats"]["spec_discarded"] >= 1
    sync = _port("synthetic", driver, geom, rounds="sync", backend=backend,
                 min_support=min_support, **kw)
    assert _same_lattice(got, sync)
    assert all(sync["stats"][f] == 0 for f in SPEC_FIELDS)


def test_async_mrganter_keeps_the_lectic_order(jax_reference):  # noqa: F811
    """MRGanter's async walk emits the whole lattice in the sync walk's
    lectic order, as the reference's does."""
    got = _port("small", "mrganter", (2, 1))
    assert got == _reference("small", "mrganter", (2, 1))
    assert got["intents"] == _port("small", "mrganter", (2, 1), rounds="sync")["intents"]


# -- round-budget boundaries ----------------------------------------------------


def _root_frontier(pkg, ctx, plan, **kw):
    eng = pkg.ClosureEngine(ctx, plan=plan, **kw)
    fr = pkg.DeviceFrontier(eng, dedupe_closures=True)
    fr.set_frontier(np.zeros((1, ctx.W), np.uint32))
    return eng, fr


def _first_spec(geom, **plan_kw):
    """The root frontier's first speculative round, reconciled, in both
    packages: ``(ref (eng, rec), port (eng, rec))``."""
    ref_plan, port_plan = _plans(geom, **plan_kw)
    out = []
    for pkg, ctx, plan, kw in ((ref_core, _context("synthetic"), ref_plan, {"backend": "jnp"}),
                               (core, _context("synthetic", True), port_plan,
                                {"device": "cpu"})):
        eng, fr = _root_frontier(pkg, ctx, plan, **kw)
        out.append((eng, fr.reconcile_oplus(fr.spec_oplus(dedupe=True), min_support=None)))
    return out


def _same_round(ref, port) -> None:
    (ref_eng, ref_rec), (eng, rec) = ref, port
    assert (rec.n_seeds, rec.under_covered) == (ref_rec.n_seeds, ref_rec.under_covered)
    np.testing.assert_array_equal(rec.closures, np.asarray(ref_rec.closures, np.uint32))
    assert {k: getattr(eng.stats, k) for k in STAT_FIELDS} == {
        k: getattr(ref_eng.stats, k) for k in STAT_FIELDS}


def _sync_first_round(geom, **plan_kw) -> set:
    _, fr = _root_frontier(core, _context("synthetic", True), _plans(geom, **plan_kw)[1],
                           device="cpu")
    return {r.tobytes() for r in fr.step_oplus(dedupe=True)}


@pytest.mark.parametrize("cand_parts", [1, 2])
def test_spec_covered_at_exact_budget_boundary(jax_reference, cand_parts):  # noqa: F811
    """A speculative chunk whose padded cap lands exactly on the true seed
    count adopts without a fallback, its closures equal to the sync
    step's."""
    _, (_, first) = _first_spec((2, cand_parts), max_batch=4096)
    budget = bucket_size(first.n_seeds)
    mb = -(-budget // cand_parts)
    ref, port = _first_spec((2, cand_parts), max_batch=mb)
    _same_round(ref, port)
    eng, rec = port
    assert not rec.under_covered and eng.stats.spec_fallbacks == 0
    assert {r.tobytes() for r in rec.closures} == _sync_first_round((2, cand_parts),
                                                                     max_batch=mb)


@pytest.mark.parametrize("cand_parts", [1, 2])
def test_spec_over_expansion_falls_back(jax_reference, cand_parts):  # noqa: F811
    """One seed past the budget: the speculative chunk under-covers, the
    reconcile closes the tail synchronously, and nothing is lost."""
    _, (_, first) = _first_spec((2, cand_parts), max_batch=4096)
    p2 = 1 << ((first.n_seeds - 1).bit_length() - 1)  # the largest power of two < n
    assert p2 < first.n_seeds
    mb = max(1, p2 // cand_parts)
    ref, port = _first_spec((2, cand_parts), max_batch=mb)
    _same_round(ref, port)
    eng, rec = port
    assert rec.under_covered and eng.stats.spec_fallbacks == 1
    assert {r.tobytes() for r in rec.closures} == _sync_first_round((2, cand_parts),
                                                                     max_batch=mb)


@pytest.mark.parametrize("geom", [(2, 1), (2, 2)])
@pytest.mark.parametrize("driver", ["mrganter+", "mrcbo"])
def test_tiny_budget_falls_back_and_matches(jax_reference, driver, geom):  # noqa: F811
    """A round budget far below the peak frontier forces the fallback again
    and again; nothing of the result changes."""
    got = _port("synthetic", driver, geom, max_batch=16)
    assert got == _reference("synthetic", driver, geom, max_batch=16)
    assert got["stats"]["spec_fallbacks"] >= 1
    assert _same_lattice(got, _port("synthetic", driver, geom, rounds="sync", max_batch=16))


# -- an empty true frontier, the one-concept context ------------------------------


@pytest.mark.parametrize("driver", ["mrganter+", "mrcbo"])
def test_empty_frontier_after_spec_iceberg(jax_reference, driver):  # noqa: F811
    """A threshold that prunes a whole round: the round speculating on its
    survivors is discarded, and the result is sync's."""
    s = int(0.6 * _context("synthetic").n_objects)
    got = _port("synthetic", driver, (2, 1), min_support=s)
    assert got == _reference("synthetic", driver, (2, 1), min_support=s)
    assert got["stats"]["spec_discarded"] >= 1
    assert _same_lattice(got, _port("synthetic", driver, (2, 1), rounds="sync",
                                    min_support=s))


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_all_ones_context(jax_reference, driver):  # noqa: F811
    """One concept: the first speculation is garbage and is discarded with
    no extra iteration counted."""
    got = _port("all-ones", driver, (2, 1))
    assert got == _reference("all-ones", driver, (2, 1))
    assert len(got["intents"]) == 1
    assert _same_lattice(got, _port("all-ones", driver, (2, 1), rounds="sync"))


# -- guards under async state ----------------------------------------------------


def _cbo_frontiers():
    ref_plan, port_plan = _plans((2, 1))
    out = []
    for pkg, ctx, plan, kw in ((ref_core, _context("synthetic"), ref_plan, {"backend": "jnp"}),
                               (core, _context("synthetic", True), port_plan,
                                {"device": "cpu"})):
        fr = pkg.DeviceFrontier(pkg.ClosureEngine(ctx, plan=plan, **kw))
        fr.set_frontier(np.zeros((1, ctx.W), np.uint32), gens=np.full(1, -1, np.int32))
        out.append(fr)
    return out


def test_len_raises_while_speculative(jax_reference):  # noqa: F811
    for fr in _cbo_frontiers():
        fr.spec_cbo()
        with pytest.raises(RuntimeError, match="speculative"):
            len(fr)


def test_adopt_refuses_to_drop_rows_under_async(jax_reference):  # noqa: F811
    """The truncation guard keeps firing while the count is on the device:
    adopting more rows than the buffer holds raises, in both packages."""
    ref_fr, fr = _cbo_frontiers()
    W = _context("synthetic").W
    for frontier, rows in ((ref_fr, np.zeros((4, W), np.uint32)),
                           (fr, torch.zeros((4, W), dtype=torch.int32))):
        spec = frontier.spec_cbo()
        with pytest.raises(RuntimeError, match="cand-shards"):
            frontier._adopt(rows, None, 9)
        frontier.discard_spec(spec)
    assert fr.engine.stats.spec_discarded == ref_fr.engine.stats.spec_discarded == 1


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_max_iterations_parity(jax_reference, driver):  # noqa: F811
    for cap in (1, 2, 4):
        got = _port("synthetic", driver, (2, 1), max_iterations=cap)
        assert got == _reference("synthetic", driver, (2, 1), max_iterations=cap), cap
        assert got["iterations"] == cap
        assert _same_lattice(got, _port("synthetic", driver, (2, 1), rounds="sync",
                                        max_iterations=cap))


# -- K2 and K4 with the count on the device ---------------------------------------


@pytest.mark.parametrize("variant", list(fk.VARIANTS))
def test_plain_versions_take_the_count_as_a_tensor(variant):
    """fused_step_plain and filter_step_plain (and the wrappers, which run
    them on the CPU) give the same closures, supports and keep with
    n_valid as an int and as a 0-dim int32 tensor, row_off 0 or not."""
    iceberg, cbo, _ = fk.VARIANTS[variant]
    rng = np.random.default_rng(23)
    W, N, B, K = 3, 200, 40, 4
    rows = t(random_bits(rng, N, W, 0.7))
    cands = t(random_bits(rng, B, W, 0.1))
    mask = t(np.full((1, W), 0xFFFFFFF0, np.uint32))
    parent = t(random_bits(rng, B, W, 0.05))
    lowrow = t(random_bits(rng, B, W, 0.01))
    lc = t(random_bits(rng, K * B, W, 0.9)).reshape(K, B, W)
    ls = torch.from_numpy(rng.integers(0, 40, size=(K, B)).astype(np.int32))
    LOW = t(random_bits(rng, W * 32, W, 0.01))
    gens = torch.from_numpy(rng.integers(-1, W * 32 + 1, size=B).astype(np.int32))
    k2_kw = dict(iceberg=iceberg, cbo=cbo, **({"parent": parent, "lowrow": lowrow} if cbo else {}))
    k4_kw = dict(iceberg=iceberg, cbo=cbo,
                 **({"parent": parent, "LOW": LOW, "gens": gens} if cbo else {}))
    kept = set()
    for n_valid in (0, 1, B - 1, B, B + 5):
        for row_off in (0, B // 4):
            sc = (n_valid, 3, 1, row_off)
            dev = (torch.tensor(n_valid, dtype=torch.int32), *sc[1:])
            for fn, args, kw in (
                (fk.fused_step_plain, (rows, cands, mask), k2_kw),
                (fk.fused_step, (rows, cands, mask), k2_kw),
                (fk.filter_step_plain, (lc, ls if iceberg else None), k4_kw),
                (fk.filter_step, (lc, ls if iceberg else None), k4_kw),
            ):
                want, got = fn(*args, sc, **kw), fn(*args, dev, **kw)
                for w, g in zip(want, got):
                    assert (w is None and g is None) or torch.equal(w, g)
                kept.add(int(got[2].sum()))
    assert len(kept) > 2  # the count and the offset do move the keep mask


def test_pack_scalars_keeps_a_device_count():
    n = torch.tensor(7, dtype=torch.int32)
    sc = fk.pack_scalars(n, 2, 3, 4)
    assert sc[0] is n and sc[1:] == (2, 3, 4)
    assert fk.pack_scalars(7, 2, 3, 4) == (7, 2, 3, 4)
    for bad in (torch.tensor([7], dtype=torch.int32), torch.tensor(7)):
        with pytest.raises(ValueError, match="0-dim int32"):
            fk.pack_scalars(bad)


# -- a 2-rank gloo group --------------------------------------------------------

GROUP_BODY = """
import dataclasses
import repro_torch.core as core
from repro_torch.core.engine import EngineStats
from repro_torch.dist.shardplan import ShardPlan

STAT_FIELDS = [f.name for f in dataclasses.fields(EngineStats) if f.type in ("int", "dict")]
ctx = core.FormalContext.synthetic(90, 21, 0.25, seed=7)
out = {}
for name in ("mrganter+", "mrcbo"):
    for backend in ("kernel", "torch"):
        for ms in (None, 4):
            plan = ShardPlan.over_group(None, "cpu", block_n=64)
            eng = core.ClosureEngine(ctx, plan=plan, backend=backend)
            kw = {"local_prune": True} if name == "mrganter+" else {}
            drive = core.mrganter_plus if name == "mrganter+" else core.mrcbo
            res = drive(ctx, eng, rounds="async", min_support=ms, **kw)
            out[f"{name}/{backend}/{ms}"] = {
                "intents": [y.tobytes().hex() for y in res.intents],
                "iterations": res.n_iterations,
                "closures": res.n_closures_computed,
                "bytes": res.modeled_comm_bytes,
                "stats": {k: getattr(eng.stats, k) for k in STAT_FIELDS},
            }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("pg_async"), GROUP_BODY, world=2)


@pytest.mark.parametrize("driver", ["mrganter+", "mrcbo"])
def test_process_group_async_matches_reference(jax_reference, group_runs,  # noqa: F811
                                               driver):
    """Each of 2 gloo ranks runs the same chain on its own count: every
    rank's async run equals the reference's async run on 2 simulated
    shards, for both backends, iceberg or not."""
    for ms in (None, 4):
        want = _reference("synthetic", driver, (2, 1), min_support=ms)
        for rank, out in enumerate(group_runs):
            for backend in ("kernel", "torch"):
                assert out[f"{driver}/{backend}/{ms}"] == want, (rank, backend, ms)


# -- the CLI --------------------------------------------------------------------


def test_cli_async_trace_matches_reference_cli(jax_reference, tmp_path, capsys):  # noqa: F811
    """``fca mine --rounds async --trace`` on mushroom 0.01: a valid trace
    with a speculative dispatch inside an earlier round, the spec spans in
    the rollup, and the reference CLI's JSON on the shared keys (walls
    excepted)."""
    argv = ["mine", "--dataset", "mushroom", "--scale", "0.01", "--parts", "4",
            "--local-prune", "--rounds", "async"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_fca.main(argv + ["--backend", "jnp"])
    want = json.loads(buf.getvalue())
    trace, stats = tmp_path / "t.json", tmp_path / "s.json"
    fca.main(argv + ["--trace", str(trace), "--stats-json", str(stats), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert json.loads(stats.read_text()) == got
    assert got["rounds"] == "async" and got["spec_rounds"] > 0
    assert {"spec/dispatch", "spec/reconcile"} <= set(got["span_rollup"])
    obj = json.loads(trace.read_text())
    assert validate_trace(obj)["async_spans"] == got["spec_rounds"]
    # round r+1's dispatch began while round r was still in flight
    assert any(o["span"].startswith("spec/dispatch")
               and int(o["span"][len("spec/dispatch["):-1]) > o["round_id"]
               for o in async_overlaps(obj))
    assert obs_trace.main([str(trace), "--expect-async-overlap"]) == 0
    shared = (set(want) & set(got)) - {"wall_time_s", "dispatch_s", "host_blocked_s",
                                       "plan", "backend"}
    assert {"concepts", "iterations", "closures_computed", "modeled_comm_bytes", "rounds",
            "spec_rounds", "spec_fallbacks", "spec_discarded"} <= shared
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
