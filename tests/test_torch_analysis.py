"""The port's static checks (``repro_torch.analysis``) against the JAX
package's ``repro.analysis``.

- lint: the port's linter over ``tests/fixtures_analysis/lint_*.py`` gives
  the reference's findings (rule, qualname, line) for the rules both
  packages share word for word (wall-clock, mutable-default, bare-except);
  torch-idiom sources trip and silence host-sync and jit-in-loop; the
  allowlist suppresses by qualname; the port's tree lints clean.
- locks: the fixtures give the reference's findings and inferences
  exactly; the port's serve-tier targets audit clean.
- fuzz: the same seed draws the reference's schedule draw for draw, and
  every batch observes the reference's versions; the injected race fires
  with the reference's findings; the blindness self-test runs.
- spmd: the recording audit's sweep is clean with at least the reference
  test's coverage; its recorded bytes equal the reference plan's model at
  the same shapes, and over whole mining runs the port engine's and the
  reference engine's census; seeded defects are flagged; a 2-rank gloo
  group and a 2 x 2 gloo mesh record their primitives in schedule order.
- the rest: the committed inventory is fresh, the frontier's step cache
  builds once under contention (C4), the injected clocks, the CLI.

Reference code runs only inside the ``jax_reference`` fixture.  Tolerance:
exact equality throughout.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import random
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.analysis.fuzz as ref_fuzz
import repro.analysis.lint as ref_lint
import repro.analysis.locks as ref_locks
import repro.core as ref_core
from repro.dist import shardplan as ref_sp
import repro_torch.core as core
from repro_torch.analysis import Report, findings as findings_mod
from repro_torch.analysis import fuzz, inventory, lint, locks, spmd_audit
from repro_torch.dist import collectives
from repro_torch.dist.shardplan import ShardPlan

from _torch_reference import jax_reference, port_context  # noqa: F401
from test_torch_collectives import run_ranks

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures_analysis"
CPU = torch.device("cpu")
SHARED_RULES = ("wall-clock", "mutable-default", "bare-except")
# where each shared rule's message names the qualname
QUALNAME = {
    "wall-clock": re.compile(r"\(([\w.<>]+)\)"),
    "mutable-default": re.compile(r"argument in ([\w.<>]+)"),
    "bare-except": re.compile(r"in ([\w.<>]+) —"),
}


def _lint(mod, monkeypatch, path: pathlib.Path, rel: str, allow=None):
    monkeypatch.setitem(mod.ASYNC_SCOPES, rel, (r".*_async$",))
    monkeypatch.setattr(mod, "CLOCK_SCOPES", mod.CLOCK_SCOPES + (rel,))
    return mod.lint_file(path, rel, allow or {})


def _shared(found) -> list[tuple]:
    return sorted(
        (f.rule, QUALNAME[f.rule].search(f.message).group(1), f.location)
        for f in found if f.rule in SHARED_RULES
    )


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lint_bad.py", "lint_good.py"])
def test_lint_fixtures_give_the_reference_findings(jax_reference, monkeypatch,  # noqa: F811
                                                   name):
    rel = f"tests/fixtures_analysis/{name}"
    got = _shared(_lint(lint, monkeypatch, FIXTURES / name, rel))
    want = _shared(_lint(ref_lint, monkeypatch, FIXTURES / name, rel))
    assert got == want
    assert len(got) == (3 if name == "lint_bad.py" else 0)


TORCH_BAD = '''
import numpy as np
import torch
from repro_torch.device import host_bits
from repro_torch.kernels import _build


def rounds_async(xs, ev, stream):
    out = []
    for x in xs:
        out.append(x.item())
        out.append(x.tolist())
        out.append(x.cpu())
        out.append(x.numpy())
        out.append(np.asarray(x))
        out.append(host_bits(x))
        torch.cuda.synchronize()
        ev.synchronize()
        stream.synchronize()
    return out


def compile_per_item(fns, xs):
    out = []
    for fn, x in zip(fns, xs):
        out.append(torch.compile(fn)(x))
        out.append(torch.jit.script(fn)(x))
        out.append(torch.jit.trace(fn, x)(x))
    while xs:
        _build.build(("frontier",))
        _build.load("serve")
        xs = xs[1:]
    return out
'''

TORCH_GOOD = '''
import numpy as np
import torch
from repro_torch.device import host_bits
from repro_torch.kernels import _build


def rounds_async(xs, ev):
    out = []
    for x in xs:
        out.append(x.item())  # sync: ok — test fixture reconcile point
        ev.synchronize()  # sync: ok — the one wait
    return out


def reconcile_results(xs):
    # host reads OUTSIDE the async scopes are ordinary and legal
    torch.cuda.synchronize()
    return [host_bits(x) for x in xs] + [np.asarray(x.cpu().numpy()) for x in xs]


def compile_once(fn, xs):
    step = torch.compile(fn)
    lib = _build.load("frontier")
    return [step(x) for x in xs], lib
'''


def test_torch_idiom_sources_trip_and_silence_host_sync_and_jit_in_loop(
        monkeypatch, tmp_path):
    (tmp_path / "bad.py").write_text(TORCH_BAD)
    (tmp_path / "good.py").write_text(TORCH_GOOD)
    bad = _lint(lint, monkeypatch, tmp_path / "bad.py", "bad.py")
    by_rule = {}
    for f in bad:
        by_rule.setdefault(f.rule, []).append(f)
    assert sorted(by_rule) == ["host-sync", "jit-in-loop"]
    # .item .tolist .cpu .numpy, np.asarray, host_bits, and three waits
    assert len(by_rule["host-sync"]) == 9
    assert all("rounds_async" in f.message for f in by_rule["host-sync"])
    # torch.compile, torch.jit.script, torch.jit.trace, _build.build, _build.load
    assert len(by_rule["jit-in-loop"]) == 5
    assert _lint(lint, monkeypatch, tmp_path / "good.py", "good.py") == []


def test_lint_allowlist_suppresses_by_qualname(monkeypatch, tmp_path):
    (tmp_path / "bad.py").write_text(TORCH_BAD)
    allow = {"host-sync": {"bad.py::rounds_async"}}
    found = _lint(lint, monkeypatch, tmp_path / "bad.py", "bad.py", allow)
    assert {f.rule for f in found} == {"jit-in-loop"}


def test_lint_port_tree_is_clean():
    report = Report()
    assert lint.run(report) == []
    assert report.checked["lint.files"] >= 75
    # the allowlist names the three reconcile points and the LM engine's
    # timers, and each entry suppresses a real finding
    allow = lint.load_allowlist()
    assert sum(len(v) for v in allow.values()) == 4
    unallowed = lint.run(Report(), allowlist_path=REPO / "no-allowlist.json")
    hit = {(f.rule, f.location.split(":")[0]) for f in unallowed}
    assert hit == {("host-sync", "src/repro_torch/core/frontier.py"),
                   ("wall-clock", "src/repro_torch/serve/engine.py")}


# ---------------------------------------------------------------------------
# locks
# ---------------------------------------------------------------------------


def _audit_record(audit) -> dict:
    return {
        "lock_attrs": audit.lock_attrs, "guarded": audit.guarded, "mutated": audit.mutated,
        "assumed_locked": audit.assumed_locked, "reachable": audit.reachable,
        "findings": [dataclasses.astuple(f) for f in audit.findings],
    }


@pytest.mark.parametrize("name,cls", [("locks_bad.py", "BadQueue"),
                                      ("locks_good.py", "GoodQueue")])
def test_lock_fixtures_give_the_reference_audit(jax_reference, name, cls):  # noqa: F811
    (got,) = locks.audit_file(FIXTURES / name, name, [(cls, ())])
    (want,) = ref_locks.audit_file(FIXTURES / name, name, [(cls, ())])
    assert _audit_record(got) == _audit_record(want)
    assert len(got.findings) == (3 if name == "locks_bad.py" else 0)


def test_lock_targets_are_the_ports_and_audit_clean():
    report = Report()
    assert locks.run(report) == []
    assert report.checked["locks.classes"] == len(locks.TARGETS) == 6
    assert all(rel.startswith("src/repro_torch/") for rel, _, _ in locks.TARGETS)


# ---------------------------------------------------------------------------
# fuzz
# ---------------------------------------------------------------------------


def _schedule(mod, monkeypatch, seed: int, inject_race: bool):
    """One schedule of ``mod``'s harness: its draws from random.Random, the
    (observed, committed) version pair of every batch, and its findings."""
    draws, engines = [], []

    class Recording(random.Random):
        def random(self):
            v = super().random()
            draws.append(v)
            return v

        def getrandbits(self, k):
            v = super().getrandbits(k)
            draws.append(v)
            return v

    class Probe(mod.ProbeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(mod.random, "Random", Recording)
    monkeypatch.setattr(mod, "ProbeEngine", Probe)
    found = mod.run_schedule(seed, steps=150, inject_race=inject_race)
    monkeypatch.undo()
    return draws, engines[0].observations, [dataclasses.astuple(f) for f in found]


@pytest.mark.parametrize("inject_race", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_fuzz_replays_the_reference_schedule(jax_reference, monkeypatch, seed,  # noqa: F811
                                             inject_race):
    got = _schedule(fuzz, monkeypatch, seed, inject_race)
    want = _schedule(ref_fuzz, monkeypatch, seed, inject_race)
    assert len(got[0]) > 150 and got[0] == want[0]
    assert got[1] and got[1] == want[1]
    assert got[2] == want[2]
    if inject_race and seed == 0:
        assert any(f[1] == "stale-after-commit" for f in got[2])
    if not inject_race:
        assert got[2] == []


def test_fuzz_clean_seeds_are_silent():
    for seed in fuzz.DEFAULT_SEEDS:
        assert fuzz.run_schedule(seed, steps=150) == [], f"seed={seed}"


def test_fuzz_pass_runs_the_blindness_self_test():
    report = Report()
    assert fuzz.run(report, seeds=(0, 1), steps=150) == []
    assert report.checked["fuzz.schedules"] == 2
    assert report.checked["fuzz.injected"] == 1


# ---------------------------------------------------------------------------
# spmd: the recording audit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spmd_run():
    report = Report()
    found = spmd_audit.run(report, device="cpu")
    return report, found


def test_spmd_audit_is_clean(spmd_run):
    _, found = spmd_run
    assert found == []


def test_spmd_audit_covered_every_variant_and_geometry(spmd_run):
    report, _ = spmd_run
    n_geo, n_impl = len(spmd_audit.GEOMETRIES), len(spmd_audit.IMPLS)
    assert spmd_audit.GEOMETRIES == ((1, 1), (4, 1), (2, 4))
    assert spmd_audit.IMPLS == ("rsag", "allgather")
    # 14 cached step variants (8 one-axis + 6 2-D) per cell, both backends
    assert report.checked["spmd.frontier_steps"] >= n_geo * n_impl * 14
    assert report.checked["spmd.frontier_steps"] == n_geo * n_impl * 14 * 2
    assert report.checked["spmd.query_steps"] >= 16
    assert report.checked["spmd.basis_passes"] == 3
    assert report.checked["spmd.self_tests"] == 1


@pytest.mark.parametrize("impl", spmd_audit.IMPLS)
@pytest.mark.parametrize("geometry", spmd_audit.GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_recorded_bytes_equal_the_reference_model(jax_reference, geometry, impl):  # noqa: F811
    k, c = geometry
    ctx = spmd_audit._frontier_ctx()
    block_n = max(8, ctx.n_objects // k)
    plan = ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl, block_n=block_n)
    ref_plan = ref_sp.ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl, block_n=block_n)
    log = {}
    assert spmd_audit.audit_plan_steps(Report(), plan, device="cpu", log=log) == []
    assert len(log) == 28
    cap_g = 64  # the Alg.-5 walk's chunk: bucket_size(40 attributes)
    for label, records in log.items():
        name = label.split("/")[-1]
        B = cap_g if name.startswith("ganter") else 32
        if name.endswith("2d"):
            want = ref_plan.modeled_round_bytes_cand(B // c, ctx.W, ctx.n_attrs)
        else:
            want = ref_plan.modeled_reduce_bytes(B, ctx.W, ctx.n_attrs)
        assert sum(r["bytes"] for r in records if r["modeled"]) == want, label
        # a fused multi-shard step folds in K4 and is charged all the same
        backend = label.split("/")[0]
        if backend == "kernel" and k > 1 and not name.startswith("ganter"):
            assert [r["folded"] for r in records if r["op"] == "and_allreduce"] == [True]


MINING_PLANS = ((4, 1, "rsag"), (2, 4, "rsag"), (8, 1, "allgather"))


@pytest.mark.parametrize("driver", ["mrganter+", "mrcbo"])
@pytest.mark.parametrize("plan_key", MINING_PLANS, ids=lambda p: f"{p[0]}x{p[1]}-{p[2]}")
def test_recorded_mining_runs_equal_the_engine_census(jax_reference, plan_key,  # noqa: F811
                                                      driver):
    """Whole mining runs with the recorder on: its sum equals the port
    engine's charged census and the reference engine's."""
    k, c, impl = plan_key
    ref_ctx = ref_core.FormalContext.synthetic(60, 24, 0.35, seed=42)
    ctx = port_context(ref_ctx)

    def drive(pkg, c_, eng):
        if driver == "mrcbo":
            return pkg.mrcbo(c_, eng)
        return pkg.mrganter_plus(c_, eng, local_prune=True)

    ref_eng = ref_core.ClosureEngine(
        ref_ctx, plan=ref_sp.ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl),
        backend="jnp")
    want = drive(ref_core, ref_ctx, ref_eng).modeled_comm_bytes
    for backend in ("kernel", "torch"):
        plan = ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl)
        eng = core.ClosureEngine(ctx, plan=plan, backend=backend, device="cpu")
        with spmd_audit.recording(plan, ctx.W, two_d=c > 1, hygiene=False) as rec:
            res = drive(core, ctx, eng)
        assert rec.modeled_bytes() == eng.stats.modeled_comm_bytes == want, backend
        assert res.modeled_comm_bytes == want
        # the fused steps' reduces are K4's folds; the first closure's is not
        folded = {r.folded for r in rec.records if r.op == "and_allreduce"}
        assert folded == ({False, True} if backend == "kernel" else {False})
    assert collectives._RECORDER is None


def _audit(fn, args, *, two_d=False, plan=None, expected=0, W=2):
    plan = plan or ShardPlan.simulated(4, reduce_impl="rsag")
    return {f.rule for f in spmd_audit.audit_call(
        "defect", fn, args, plan=plan, W=W, device=CPU, two_d=two_d,
        expected_bytes=expected)}


def test_seeded_defects_are_flagged():
    plan = ShardPlan.simulated(4, reduce_impl="rsag")
    x = torch.zeros((4, 8, 2), dtype=torch.int32)
    ok = plan.modeled_reduce_bytes(8, 2)

    def one_reduce(x):
        return collectives.and_allreduce(x, plan.reduce_axes, impl="rsag")

    def extra_collective(x):
        one_reduce(x)
        return collectives.and_allreduce(x, plan.reduce_axes, impl="rsag")

    def host_read(x):
        out = one_reduce(x)
        return int(out.sum().item())

    assert _audit(one_reduce, (x,), plan=plan, expected=ok) == set()
    assert _audit(extra_collective, (x,), plan=plan, expected=ok) == {
        "reduce-schedule-mismatch", "byte-census-mismatch"}
    assert _audit(host_read, (x,), plan=plan, expected=ok) == {"host-read-in-region"}

    plan2d = ShardPlan.simulated(2, cand_parts=4, reduce_impl="rsag")
    chunk = torch.zeros((2, 32, 2), dtype=torch.int32)
    ok2d = plan2d.modeled_round_bytes_cand(8, 2)

    def reduce_then_gather(x):
        gc = collectives.and_allreduce(x, plan2d.reduce_axes, impl="rsag")[0]
        return collectives.all_gather_blocks(gc.reshape(4, 8, 2), plan2d.cand_axes)

    def gather_then_reduce(x):
        blocks = collectives.all_gather_blocks(x[0].reshape(4, 8, 2), plan2d.cand_axes)
        return collectives.and_allreduce(x, plan2d.reduce_axes, impl="rsag"), blocks

    assert _audit(reduce_then_gather, (chunk,), two_d=True, plan=plan2d,
                  expected=ok2d) == set()
    assert _audit(gather_then_reduce, (chunk,), two_d=True, plan=plan2d,
                  expected=ok2d) == {"cand-gather-before-reduce"}
    # a candidate gather inside a one-axis step binds an undeclared axis
    assert "undeclared-axis" in _audit(reduce_then_gather, (chunk,), plan=plan2d,
                                       expected=ok2d)


def test_hygiene_self_test_and_the_seam_without_a_recorder():
    assert spmd_audit.self_test(CPU) == []
    assert collectives._RECORDER is None
    x = torch.arange(12, dtype=torch.int32).reshape(3, 2, 2)
    with spmd_audit.recording(ShardPlan.simulated(3), 2) as rec:
        got = collectives.and_allreduce(x, collectives.SIM_AXIS, impl="allgather")
    assert collectives._RECORDER is None and collectives.dist is torch.distributed
    assert torch.equal(got, collectives.and_allreduce(x, collectives.SIM_AXIS,
                                                      impl="allgather"))
    assert [r.op for r in rec.records] == ["and_allreduce"]


GROUP_AUDIT = """
from repro_torch.analysis import Report, spmd_audit
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.launch.mesh import make_local_mesh

out = {}
mesh = make_local_mesh(cand=2) if world == 4 else None
for impl in ("rsag", "allgather"):
    plan = (ShardPlan.over_mesh(mesh, "cpu", reduce_impl=impl) if mesh is not None
            else ShardPlan.over_group(None, "cpu", reduce_impl=impl))
    report, log = Report(), {}
    found = spmd_audit.audit_plan_steps(report, plan, device="cpu", label=impl + "/",
                                        log=log)
    out[impl] = {"findings": [f.format() for f in found], "log": log,
                 "steps": report.checked["spmd.frontier_steps"]}
print(json.dumps(out))
"""


@pytest.mark.parametrize("world", [2, 4], ids=["group2", "mesh2x2"])
def test_process_groups_record_their_primitives_in_schedule_order(tmp_path, world):
    runs = run_ranks(tmp_path, GROUP_AUDIT, world=world)
    for impl in ("rsag", "allgather"):
        logs = [r[impl]["log"] for r in runs]
        assert all(r[impl]["findings"] == [] for r in runs), runs[0][impl]["findings"]
        assert all(r[impl]["steps"] == 28 for r in runs)
        assert all(log == logs[0] for log in logs)  # every rank records the same
        log = logs[0]
        red = ["all_to_all", "all_gather"] if impl == "rsag" else ["all_gather"]
        for backend in ("torch", "kernel"):
            pfx = f"{impl}/{backend}/"
            assert [(r["op"], r["axis"], r["prims"]) for r in log[pfx + "cbo_iceberg"]] == [
                ("and_allreduce", "object", red), ("sum_allreduce", "object", ["psum"])]
            steps2d = [(r["op"], r["axis"], r["prims"]) for r in log[pfx + "cbo_iceberg2d"]]
            if world == 2:  # a 1-D plan: the 2-D steps have one block
                assert steps2d[:2] == [("and_allreduce", "object", red),
                                       ("sum_allreduce", "object", ["psum"])]
                assert len(steps2d) == 2
            else:  # reduce over the object pair, then gather z, gens, counts
                assert steps2d == [("and_allreduce", "object", red),
                                   ("sum_allreduce", "object", ["psum"])] + [
                    ("all_gather_blocks", "candidate", ["all_gather"])] * 3
                assert [r["modeled"] for r in log[pfx + "cbo_iceberg2d"]] == [
                    True, False, True, False, False]


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------


def test_committed_inventory_is_fresh():
    committed = json.loads((REPO / inventory.DEFAULT_PATH).read_text())
    current = inventory.build_inventory(REPO)
    assert committed == current, (
        "ANALYSIS_inventory_torch.json is stale — regenerate with "
        "`PYTHONPATH=src python -m repro_torch.analysis --inventory`"
    )
    assert "repro_torch.analysis.spmd_audit" not in {d["module"] for d in current["dead"]}


def test_frontier_step_cache_builds_once_under_contention():
    """C4: the step cache is built under the engine's lock; 8 threads that
    all miss one cold step build it once and share one callable."""
    from repro_torch.core.frontier import DeviceFrontier

    ctx = spmd_audit._frontier_ctx()
    engine = core.ClosureEngine(
        ctx, plan=ShardPlan.simulated(2, block_n=12), backend="torch", device="cpu"
    )
    frontier = DeviceFrontier(engine)
    name = sorted(frontier._cache["builders"])[0]
    builds = []
    orig = frontier._cache["builders"][name]

    def slow_build():
        builds.append(1)
        threading.Event().wait(0.05)  # widen the window a racing miss needs
        return orig()

    frontier._cache["builders"][name] = slow_build
    n = 8
    barrier = threading.Barrier(n)
    steps = [None] * n

    def hit(i):
        barrier.wait()
        steps[i] = DeviceFrontier(engine)._step_fn(name)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert len({id(s) for s in steps}) == 1


def test_stream_updater_uses_injected_clock():
    from repro_torch.query.stream import StreamUpdater

    store = spmd_audit._tiny_store(1, "rsag")
    clock = fuzz.VirtualClock()  # frozen unless explicitly advanced
    upd = StreamUpdater(store, clock=clock)
    receipt = upd.stage(np.array([[0b1010_0101]], np.uint32))
    # a wall-clock read anywhere in the stage path would make this > 0
    assert receipt.stage_wall_s == 0.0
    assert receipt.n_new_objects == 1


def test_query_engine_uses_injected_clock():
    from repro_torch.query.engine import QueryEngine

    store = spmd_audit._tiny_store(1, "rsag")
    engine = QueryEngine(store, clock=fuzz.VirtualClock())
    engine.closure_batch(np.zeros((2, 1), np.uint32))
    h = engine.stats.registry.histogram("service_s", kind="closure")
    assert h.count >= 1
    assert h.sum == 0.0  # service time on the frozen virtual clock


def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError):
        findings_mod.Finding("lint", "x", "y", "z", severity="fatal")


def test_cli_strict_json_and_inventory(tmp_path):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}

    def cli(*argv):
        return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *argv],
                              capture_output=True, text=True, timeout=300, env=env, cwd=REPO)

    strict = cli("--strict", "--json")
    assert strict.returncode == 0, strict.stdout + strict.stderr
    doc = json.loads(strict.stdout)
    assert doc["ok"] is True and doc["findings"] == []
    assert doc["checked"]["spmd.frontier_steps"] == 168
    out = tmp_path / "inv.json"
    inv = cli("--inventory", str(out))
    assert inv.returncode == 0, inv.stderr
    assert json.loads(out.read_text()) == inventory.build_inventory(REPO)
    quick = cli("--pass", "lint", "--pass", "locks")
    assert quick.returncode == 0 and "locks.classes=6" in quick.stdout


def test_the_package_guards_cover_the_analysis_modules():
    from test_torch_package import _modules

    mods = set(_modules())
    assert {"repro_torch.analysis", "repro_torch.analysis.__main__",
            "repro_torch.analysis.spmd_audit", "repro_torch.analysis.lint",
            "repro_torch.analysis.locks", "repro_torch.analysis.fuzz",
            "repro_torch.analysis.inventory", "repro_torch.analysis.findings"} <= mods


@pytest.mark.parametrize("backend", ["torch", "matmul"])
def test_rules_step_makes_no_tensor_from_host_data(backend):
    """C5: the plain rules step turned ``min_conf`` into a device tensor on
    every micro-batch — on a card a synchronising host-to-device copy, which
    ``set_sync_debug_mode("error")`` raised on.  The threshold now stays a
    host float32 scalar; the answers are unchanged (the rules tests)."""
    from repro_torch.query.engine import QueryConfig, QueryEngine

    store = spmd_audit._tiny_store(1, "rsag")
    qe = QueryEngine(store, QueryConfig(backend=backend))
    rng = np.random.default_rng(9)
    words = [torch.from_numpy(rng.integers(0, 256, size=(8, 1), dtype=np.uint32)
                              .view(np.int32)) for _ in range(3)]
    args = (words[0], words[1], torch.rand(8), torch.rand(8),
            torch.arange(8, dtype=torch.int32), 8, words[2], np.float32(0.25))
    found = spmd_audit.audit_call("rules", qe._rules_step(5), args, plan=store.plan, W=1,
                                  device=CPU, replicated=True)
    assert found == []
