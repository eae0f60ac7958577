"""The port's serving-under-load tier against the JAX package's.

The admission queue over the port's ``QueryEngine`` (deadline-or-full
dispatch, bounded-depth shed, bit-identity with pre-formed batches, a
dispatcher thread whose failures surface), the arrival processes, the
open-loop driver on a virtual clock, snapshot swaps racing dispatches,
the OpenMetrics exporter and the SLO evaluation and gate: each test of
the reference's ``tests/test_serve_load.py`` on the port, then parity
with the reference on the same inputs — seeded arrivals and workloads,
virtual-clock load reports with every ticket's answer (closure, top-k,
lookup, rules, and a run with streamed updates), OpenMetrics text byte for
byte, SLO and gate verdicts, the ``fca serve --load-qps`` key set, and its
refusal under a process group of two ranks.  Small contexts
(``FormalContext.synthetic(60, 18, 0.3, seed=5)`` on
``ShardPlan.simulated(2, block_n=16)``; mushroom at scale 0.01 for
updates), slots 8, the torch backend on the CPU.  Tolerance: exact
equality (every compared value is an integer, a bitset, or a float
computed by the same Python arithmetic on the same inputs).
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.core.context as ref_context
import repro.obs as ref_obs
import repro.obs.slo as ref_slo
import repro.serve as ref_serve
from repro.data import fca_datasets as ref_datasets
from repro.dist.shardplan import ShardPlan as RefPlan
from repro.launch import fca as ref_fca
from repro.query import ConceptStore as RefStore
from repro.query import QueryEngine as RefEngine
from repro.query import StreamUpdater as RefUpdater
from repro.query.engine import QueryConfig as RefConfig
from repro import rules as ref_rules
import repro_torch.obs as obs
import repro_torch.obs.slo as slo
import repro_torch.serve as serve
from repro_torch.core import all_closures_batched, bitset
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.launch import fca
from repro_torch.obs import (
    SLO,
    MetricsServer,
    Tracer,
    burn_rate,
    check_baselines,
    evaluate,
    parse_openmetrics,
    run_gate,
    sanitize_name,
    span_rollup,
    to_openmetrics,
    use_tracer,
)
from repro_torch.query import ConceptStore, QueryConfig, QueryEngine, StreamUpdater
from repro_torch import rules
from repro_torch.serve import (
    AdmissionConfig,
    AdmissionQueue,
    burst_arrivals,
    make_workload,
    poisson_arrivals,
    run_load,
)

from _torch_reference import jax_reference, port_context, repair_livelock  # noqa: F401
from test_torch_collectives import run_ranks

SLOTS = 8


@pytest.fixture(scope="module")
def ref_ctx():
    return ref_context.FormalContext.synthetic(60, 18, 0.3, seed=5)


@pytest.fixture(scope="module")
def ctx(ref_ctx):
    return port_context(ref_ctx)


@pytest.fixture(scope="module")
def intents(ctx):
    return np.stack(all_closures_batched(ctx))


@pytest.fixture(scope="module")
def served(ctx, intents):
    plan = ShardPlan.simulated(2, block_n=16)
    store = ConceptStore.build(ctx, intents, plan=plan, device="cpu")
    return store, QueryEngine(store, QueryConfig(slots=SLOTS, backend="torch"))


def _queries(ctx, n, seed=0):
    rng = np.random.default_rng(seed)
    base = ctx.rows[rng.integers(0, ctx.n_objects, size=n)]
    keep = bitset.pack_bool(rng.random((n, ctx.n_attrs)) < 0.25, ctx.W)
    return base & keep


def _virtual_clock(start=0.0):
    t = [start]
    return (lambda: t[0]), (lambda s: t.__setitem__(0, t[0] + s)), t


# -- admission semantics -----------------------------------------------------


def test_queue_results_bit_identical_to_preformed_batch(served):
    _, qe = served
    qs = _queries(qe.store.ctx, 3 * SLOTS + 2, seed=1)
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=10.0))
    tickets = [queue.submit("closure", q) for q in qs]
    queue.flush()
    closures, supports, ids = qe.closure_batch(qs)
    for t, ec, es, ei in zip(tickets, closures, supports, ids):
        tc, ts, ti = t.result
        assert isinstance(tc, np.ndarray)  # numpy at the queue boundary
        assert np.array_equal(tc, ec)
        assert int(ts) == int(es) and int(ti) == int(ei)


def test_full_batch_dispatches_inline_before_deadline(served):
    _, qe = served
    qs = _queries(qe.store.ctx, SLOTS, seed=2)
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=60.0))
    tickets = [queue.submit("closure", q) for q in qs]
    # the slots-th submit fills the batch: dispatched without any poll
    assert all(t.done for t in tickets)
    assert queue.stats.dispatch_causes == {"full": 1}
    assert queue.stats.occupancy_mean == 1.0
    assert queue.pending() == 0


def test_deadline_fires_partial_batch_on_fake_clock(served):
    _, qe = served
    clock, _, t = _virtual_clock()
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=1.0), clock=clock)
    qs = _queries(qe.store.ctx, 3, seed=3)
    tickets = [queue.submit("closure", q) for q in qs]
    assert queue.poll() == 0  # not due, not full
    assert not any(t_.done for t_ in tickets)
    assert queue.next_deadline_in() == pytest.approx(1.0)
    t[0] = 1.5  # oldest ticket aged past max_wait_s
    assert queue.poll() == 1
    assert all(t_.done for t_ in tickets)
    assert queue.stats.dispatch_causes == {"deadline": 1}
    assert queue.stats.occupancy_mean == pytest.approx(3 / SLOTS)
    # e2e on the fake clock: dispatched at 1.5, arrived at 0
    assert tickets[0].e2e_s == pytest.approx(1.5)


def test_bounded_depth_sheds_at_submit(served):
    _, qe = served
    depth = 5
    queue = AdmissionQueue(
        qe, AdmissionConfig(max_wait_s=60.0, depth=depth), clock=lambda: 0.0
    )
    # depth < slots so nothing dispatches; overflow must shed
    qs = _queries(qe.store.ctx, depth + 3, seed=4)
    tickets = [queue.submit("closure", q) for q in qs]
    st = queue.stats
    assert [t.shed for t in tickets] == [False] * depth + [True] * 3
    assert st.submitted == depth + 3 and st.shed == 3
    assert st.admitted == depth
    assert st.shed_rate == pytest.approx(3 / (depth + 3))
    assert all(t.result is None and t.done for t in tickets[depth:])
    snap = queue.registry.export()
    assert snap["serve_shed_total{kind=closure}"] == 3
    assert snap["serve_queue_depth{kind=closure}"] == depth
    queue.flush()
    assert st.completed == depth  # shed tickets never reach the engine


def test_rules_kind_requires_index_and_unknown_kind_rejected(served):
    _, qe = served
    queue = AdmissionQueue(qe)
    with pytest.raises(ValueError, match="rules_index"):
        queue.submit("rules", _queries(qe.store.ctx, 1)[0])
    with pytest.raises(ValueError, match="unknown kind"):
        queue.submit("update", _queries(qe.store.ctx, 1)[0])


def test_dispatch_emits_span_and_registry_series(served):
    _, qe = served
    tr = Tracer()
    with use_tracer(tr):
        queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=10.0))
        # the engine registry is shared across this module's queues (one
        # /metrics snapshot covers queue + engine), so assert deltas
        before = queue.registry.export()
        for q in _queries(qe.store.ctx, SLOTS + 2, seed=5):
            queue.submit("closure", q)
        queue.flush()
    roll = span_rollup(tr.to_dict()["traceEvents"])
    assert roll["serve/dispatch"]["count"] == 2  # one full + one flush
    b = next(e for e in tr.to_dict()["traceEvents"]
             if e["ph"] == "B" and e["name"] == "serve/dispatch")
    assert b["args"]["kind"] == "closure" and b["args"]["n"] == SLOTS
    snap = queue.registry.export()

    def delta(key):
        now = snap.get(key, 0)
        was = before.get(key, 0)
        if isinstance(now, dict):
            return now["count"] - (was["count"] if isinstance(was, dict) else 0)
        return now - was

    assert delta("serve_submitted_total{kind=closure}") == SLOTS + 2
    assert delta("serve_dispatch_total{cause=full,kind=closure}") == 1
    assert delta("serve_dispatch_total{cause=flush,kind=closure}") == 1
    assert delta("serve_e2e_s{kind=closure}") == SLOTS + 2
    assert delta("serve_slot_occupancy") == 2


# -- arrival processes + workload mix ----------------------------------------


def test_poisson_arrivals_hit_target_rate():
    rng = np.random.default_rng(7)
    a = poisson_arrivals(200.0, 5.0, rng)
    assert a.size == pytest.approx(1000, rel=0.15)
    assert np.all(np.diff(a) >= 0) and a[-1] < 5.0
    gaps = np.diff(a)
    assert gaps.mean() == pytest.approx(1 / 200.0, rel=0.15)
    assert poisson_arrivals(0.0, 5.0, rng).size == 0


def test_burst_arrivals_keep_mean_and_show_the_factor():
    rng = np.random.default_rng(8)
    a = burst_arrivals(200.0, 20.0, rng, period_s=1.0, duty=0.25, factor=4.0)
    assert a.size == pytest.approx(4000, rel=0.15)  # mean rate preserved
    phase = (a / 1.0) % 1.0
    in_burst = (phase < 0.25).sum()
    # per-second rate ratio between the duty window and the rest ≈ factor
    ratio = (in_burst / 0.25) / ((a.size - in_burst) / 0.75)
    assert 2.5 < ratio < 6.0
    with pytest.raises(ValueError, match="factor"):
        burst_arrivals(200.0, 1.0, rng, factor=0.5)


def test_make_workload_mix_payloads_and_validation(ctx):
    rng = np.random.default_rng(9)
    events = make_workload(
        ctx, 400, rng, mix={"closure": 0.5, "lookup": 0.3, "update": 0.2}
    )
    assert len(events) == 400
    counts = {}
    for kind, payload in events:
        counts[kind] = counts.get(kind, 0) + 1
        if kind == "update":
            assert payload.shape == (2, ctx.W)
        else:
            assert payload.shape == (ctx.W,)
            # thinned real rows: subsets of context attribute space
            assert not np.any(payload & ~ctx.attr_mask())
    assert counts["closure"] == pytest.approx(200, rel=0.25)
    assert counts["update"] == pytest.approx(80, rel=0.35)
    with pytest.raises(ValueError, match="unknown workload kinds"):
        make_workload(ctx, 4, rng, mix={"extent": 1.0})
    with pytest.raises(ValueError, match="sum > 0"):
        make_workload(ctx, 4, rng, mix={"closure": 0.0})


# -- open-loop driver on a virtual clock -------------------------------------


def test_run_load_virtual_clock_accounting(served):
    _, qe = served
    clock, sleep, _ = _virtual_clock(100.0)  # virtual seconds; sleep() advances it
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=0.01), clock=clock)
    rng = np.random.default_rng(10)
    arrivals = poisson_arrivals(300.0, 1.0, rng)
    events = make_workload(
        qe.store.ctx, len(arrivals), rng, mix={"closure": 0.7, "lookup": 0.3}
    )
    rep = run_load(queue, arrivals, events, clock=clock, sleep=sleep)
    assert rep.submitted == len(arrivals)
    assert rep.admitted == rep.submitted  # depth 512 ≫ offered
    assert rep.completed == rep.admitted
    assert rep.shed == 0 and rep.shed_rate == 0.0
    assert rep.dispatches == sum(rep.dispatch_causes.values())
    assert rep.e2e["count"] == rep.completed
    assert rep.admission_wait["count"] == rep.completed
    # on the virtual clock queueing delay is bounded by the deadline
    # (dispatch itself costs zero virtual time)
    assert rep.e2e["max"] <= 0.01 + 1e-6
    assert rep.updates == 0 and rep.update_latency == {}
    d = rep.describe()
    json.dumps(d)
    assert d["shed_rate"] == 0.0
    assert rep.offered_qps == pytest.approx(len(arrivals) / float(arrivals[-1]))


def test_run_load_slo_and_backdated_arrivals(served):
    _, qe = served
    clock, sleep, _ = _virtual_clock()
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=0.005), clock=clock)
    arrivals = np.array([0.0, 0.001, 0.002, 0.5])
    events = [("closure", q) for q in _queries(qe.store.ctx, 4, seed=11)]
    rep = run_load(
        queue, arrivals, events, clock=clock, sleep=sleep,
        slo=SLO(latency_objective_s=0.25, max_shed_rate=0.0),
    )
    assert rep.slo["ok"] is True
    assert rep.slo["latency_ok"] and rep.slo["shed_ok"]
    assert rep.slo["burn_rate"] == 0.0
    # arrival_s was backdated to the schedule: tickets keep offered time
    assert rep.max_lag_s >= 0.0
    with pytest.raises(ValueError, match="one arrival time per event"):
        run_load(queue, arrivals[:2], events, clock=clock, sleep=sleep)


# -- snapshot swaps racing dispatches ----------------------------------------


def test_concurrent_commits_never_drop_or_double_count_latency(ctx, intents):
    """A StreamUpdater commit swaps the snapshot while the queue is
    dispatching micro-batches from another thread.  Every admitted
    ticket must complete exactly once, and the latency histograms must
    hold exactly one observation per completion."""
    plan = ShardPlan.simulated(2, block_n=16)
    store = ConceptStore.build(ctx, intents, plan=plan, device="cpu")  # local: commits mutate
    qe = QueryEngine(store, QueryConfig(slots=4, backend="torch"))
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=0.0005))
    updater = StreamUpdater(store)
    v0 = store.snapshot.version

    n_commits = 4
    errs = []

    def churn():
        rng = np.random.default_rng(13)
        try:
            for _ in range(n_commits):
                rows = bitset.pack_bool(rng.random((2, ctx.n_attrs)) < 0.3, ctx.W)
                updater.apply(rows)
        except Exception as e:  # noqa: BLE001 - surfaces in the main thread's assert
            errs.append(e)

    th = threading.Thread(target=churn)
    th.start()
    n = 64
    tickets = [queue.submit("closure", q) for q in _queries(ctx, n, seed=14)]
    while queue.pending():
        queue.poll()
    queue.flush()
    th.join(timeout=60)
    assert not th.is_alive() and not errs, errs

    st = queue.stats
    assert st.admitted == n and st.shed == 0
    assert st.completed == n  # nothing dropped, nothing run twice
    assert all(t.done and t.result is not None for t in tickets)
    # exactly one latency observation per completion, in both ledgers
    assert st.registry.histogram("latency_s", kind="e2e").count == n
    assert st.registry.histogram("latency_s", kind="admission_wait").count == n
    assert queue.registry.histogram("serve_e2e_s", kind="closure").count == n
    assert store.snapshot.version == v0 + n_commits
    # post-churn queries serve from the committed snapshot, bit-identical
    # to a pre-formed batch against it
    qs = _queries(ctx, 4, seed=15)
    t2 = [queue.submit("closure", q) for q in qs]
    queue.flush()
    closures, supports, ids = qe.closure_batch(qs)
    for t_, ec, es in zip(t2, closures, supports):
        assert np.array_equal(t_.result[0], ec)
        assert int(t_.result[1]) == int(es)


# -- the background dispatcher thread ----------------------------------------


def test_dispatcher_thread_serves_and_drains(served):
    _, qe = served
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=0.001))
    queue.start()
    with pytest.raises(RuntimeError, match="already running"):
        queue.start()
    qs = _queries(qe.store.ctx, 3 * SLOTS + 3, seed=16)
    tickets = [queue.submit("closure" if i % 2 else "topk", q) for i, q in enumerate(qs)]
    queue.stop(drain=True)
    assert all(t.done and not t.shed for t in tickets)
    assert queue.stats.completed == len(qs) and queue.pending() == 0
    closures = qe.closure_batch(qs[1::2])[0]
    tops, top_supports = qe.topk_batch(qs[::2], k=queue.cfg.topk_k)
    assert np.array_equal(np.stack([t.result[0] for t in tickets[1::2]]), closures)
    assert np.array_equal(np.stack([t.result[0] for t in tickets[::2]]), tops)
    assert np.array_equal(np.stack([t.result[1] for t in tickets[::2]]), top_supports)


def test_dispatcher_thread_failure_is_raised_by_stop(served):
    """A dispatch that raises inside the dispatcher thread ends the thread,
    and stop() raises it again instead of letting it vanish."""
    _, qe = served
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=0.0))

    def fail(kind, batch):
        raise ValueError("launch failed")

    queue._run = fail
    queue.start()
    ticket = queue.submit("closure", _queries(qe.store.ctx, 1, seed=17)[0])
    queue._thread.join(timeout=10)
    with pytest.raises(RuntimeError, match="dispatcher thread failed") as info:
        queue.stop(drain=False)
    assert isinstance(info.value.__cause__, ValueError)
    assert not ticket.done  # taken by the failed dispatch, never answered


def test_inline_dispatch_failure_raises_through_submit_and_flush(served):
    _, qe = served
    queue = AdmissionQueue(qe, AdmissionConfig(max_wait_s=60.0))

    def fail(kind, batch):
        raise ValueError("launch failed")

    queue._run = fail
    qs = _queries(qe.store.ctx, SLOTS, seed=18)
    for q in qs[:-1]:
        queue.submit("closure", q)
    with pytest.raises(ValueError, match="launch failed"):
        queue.submit("closure", qs[-1])  # fills the batch: dispatched inline
    queue.submit("closure", qs[0])
    with pytest.raises(ValueError, match="launch failed"):
        queue.flush()
    assert queue.stats.completed == 0


def test_serve_package_loads_the_decoder_only_on_demand():
    """``import repro_torch.serve`` for the queue imports no LM module;
    ``ServeConfig``, ``ServeEngine`` and ``GenerateStats`` still resolve."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, repro_torch.serve as s\n"
        "print(any(m.startswith(('repro_torch.serve.engine', 'repro_torch.models'))"
        " for m in sys.modules))\n"
        "print(s.ServeEngine.__module__, s.ServeConfig.__name__, s.GenerateStats.__name__)\n"
    )
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.stdout.split() == ["False", "repro_torch.serve.engine", "ServeConfig",
                                  "GenerateStats"]
    assert set(serve.__all__) == set(ref_serve.__all__) | {"ServeConfig", "ServeEngine",
                                                           "GenerateStats"}


# -- OpenMetrics export ------------------------------------------------------


def _loaded_registry(pkg=obs):
    r = pkg.Registry()
    r.counter("serve_shed_total", 3, kind="closure")
    r.counter("serve_shed_total", 1, kind="topk")
    r.gauge("serve_queue_depth", 7, kind="closure")
    r.observe("serve_e2e_s", 0.004, kind="closure")
    r.observe("serve_e2e_s", 0.020, kind="closure")
    r.observe("serve_e2e_s", 5e-7, kind="closure")  # underflow bucket
    return r


def test_openmetrics_renders_and_round_trips():
    text = to_openmetrics(_loaded_registry())
    fams = parse_openmetrics(text)  # strict validator — raises on drift
    assert fams["serve_shed"]["type"] == "counter"
    shed = {tuple(sorted(lbl.items())): v for _, lbl, v in fams["serve_shed"]["samples"]}
    assert shed[(("kind", "closure"),)] == 3.0
    # _s convention renders as _seconds with a UNIT line
    assert "# TYPE serve_e2e_seconds histogram" in text
    assert "# UNIT serve_e2e_seconds seconds" in text
    h = fams["serve_e2e_seconds"]
    assert h["type"] == "histogram"
    by_name = {}
    for name, lbl, v in h["samples"]:
        by_name.setdefault(name, []).append((lbl, v))
    (_, count), = by_name["serve_e2e_seconds_count"]
    assert count == 3.0
    inf_bucket = [v for lbl, v in by_name["serve_e2e_seconds_bucket"] if lbl["le"] == "+Inf"]
    assert inf_bucket == [3.0]
    # the sub-µs observation lands in the explicit 1e-06 underflow bucket
    first = min((float(lbl["le"]), v) for lbl, v in by_name["serve_e2e_seconds_bucket"])
    assert first == (1e-6, 1.0)


def test_openmetrics_parser_rejects_malformed():
    with pytest.raises(ValueError, match="EOF"):
        parse_openmetrics("# TYPE x counter\nx_total 1\n")
    with pytest.raises(ValueError, match="no TYPE-declared"):
        parse_openmetrics("stray_metric 1\n# EOF\n")
    bad_hist = (
        "# TYPE h histogram\n"
        'h_bucket{le="0.1"} 5\n'
        'h_bucket{le="+Inf"} 3\n'  # cumulative counts must not decrease
        "h_count 3\nh_sum 1\n# EOF\n"
    )
    with pytest.raises(ValueError, match="cumulative"):
        parse_openmetrics(bad_hist)
    with pytest.raises(ValueError, match="re-declared"):
        parse_openmetrics("# TYPE x counter\n# TYPE x counter\n# EOF\n")
    assert sanitize_name("serve_e2e_s") == "serve_e2e_seconds"
    assert sanitize_name("bad name!") == "bad_name_"


def test_metrics_server_serves_live_snapshot():
    r = _loaded_registry()
    with MetricsServer(lambda: r, port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.url.startswith("http://127.0.0.1:")
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            assert resp.status == 200
            assert "openmetrics-text" in resp.headers["Content-Type"]
            fams = parse_openmetrics(resp.read().decode())
        assert "serve_queue_depth" in fams
        r.counter("serve_shed_total", 10, kind="closure")  # live mutation
        with urllib.request.urlopen(srv.url, timeout=10) as resp:
            fams2 = parse_openmetrics(resp.read().decode())
        shed = {tuple(sorted(lbl.items())): v for _, lbl, v in fams2["serve_shed"]["samples"]}
        assert shed[(("kind", "closure"),)] == 13.0  # per-scrape provider
        bad = urllib.request.Request(srv.url.replace("/metrics", "/other"))
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=10)


# -- SLO evaluation + regression gate ----------------------------------------


def test_burn_rate_budget_semantics():
    assert burn_rate(1.0, 0.995) == 0.0
    assert burn_rate(0.99, 0.995) == pytest.approx(2.0)
    assert burn_rate(0.995, 0.995) == pytest.approx(1.0)
    assert burn_rate(1.0, 1.0) == 0.0
    assert burn_rate(0.9, 1.0) == float("inf")


def test_evaluate_verdicts():
    s = SLO(latency_objective_s=0.1, latency_target=0.99, max_shed_rate=0.01, max_p99_s=0.2)
    good = evaluate(s, compliance=0.999, shed_rate=0.0, p99_s=0.05)
    assert good["ok"] and good["latency_ok"] and good["p99_ok"]
    assert good["burn_rate"] == pytest.approx(0.1)
    bad = evaluate(s, compliance=0.9, shed_rate=0.05, p99_s=0.5)
    assert not bad["ok"]
    assert not bad["latency_ok"] and not bad["shed_ok"] and not bad["p99_ok"]
    assert bad["burn_rate"] == pytest.approx(10.0)


def test_check_baselines_tolerance_classes():
    artifact = {"headline": {"p99": 0.010, "shed_rate": 0.005, "bit_identical": True}}
    baseline = {
        "latency_s": {"headline.p99": 0.004},
        "rate": {"headline.shed_rate": 0.0},
        "exact": {"headline.bit_identical": True},
    }
    # 0.010 < 0.004×4 ceiling, 0.005 < 0+0.02 slack, invariant holds
    assert check_baselines(artifact, baseline) == []
    artifact["headline"]["p99"] = 0.040  # 10× the baseline: trips the gate
    v = check_baselines(artifact, baseline)
    assert len(v) == 1 and "latency regression" in v[0]
    artifact["headline"]["shed_rate"] = 0.5
    artifact["headline"]["bit_identical"] = False
    v = check_baselines(artifact, baseline)
    assert len(v) == 3
    assert any("rate regression" in s for s in v)
    assert any("invariant broken" in s for s in v)
    # a missing metric path is a violation, not a silent skip
    v = check_baselines({"headline": {}}, baseline)
    assert len(v) == 3 and all("no " in s for s in v)


def test_run_gate_green_then_red_on_injected_regression(tmp_path):
    artifact = {"headline": {"p99": 0.010, "bit_identical": True}}
    baselines = {
        "tolerance_ratio": 4.0,
        "artifacts": {"BENCH_x.json": {
            "latency_s": {"headline.p99": 0.008},
            "exact": {"headline.bit_identical": True},
        }},
    }
    art = tmp_path / "BENCH_x.json"
    base = tmp_path / "slo_baselines.json"
    art.write_text(json.dumps(artifact))
    base.write_text(json.dumps(baselines))
    out = io.StringIO()
    assert run_gate([str(art)], str(base), out=out) == 0
    assert "OK" in out.getvalue()
    # inject a 10× latency regression → the gate must go red
    artifact["headline"]["p99"] = 0.10
    art.write_text(json.dumps(artifact))
    out = io.StringIO()
    assert run_gate([str(art)], str(base), out=out) == 1
    assert "latency regression" in out.getvalue()
    # unknown artifact (no baseline entry) is red, not silently skipped
    other = tmp_path / "BENCH_unknown.json"
    other.write_text("{}")
    assert run_gate([str(other)], str(base), out=io.StringIO()) == 1


# -- parity with the reference: arrivals and workloads ------------------------


ARRIVAL_CASES = {
    "poisson": ("poisson", 300.0, 2.0, {}),
    "poisson-short": ("poisson", 2000.0, 0.01, {}),
    "burst": ("burst", 400.0, 3.0, {"factor": 4.0}),
    "burst-flat": ("burst", 250.0, 1.5, {"factor": 1.0, "period_s": 0.5, "duty": 0.5}),
}


@pytest.mark.parametrize("case", list(ARRIVAL_CASES))
def test_seeded_arrivals_equal_reference(case):
    name, qps, seconds, kw = ARRIVAL_CASES[case]
    got = serve.ARRIVALS[name](qps, seconds, np.random.default_rng(24), **kw)
    want = ref_serve.ARRIVALS[name](qps, seconds, np.random.default_rng(24), **kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


WORKLOAD_MIXES = {
    "default": (None, 2, None),
    "all-kinds": ({"closure": 0.5, "topk": 0.2, "lookup": 0.1, "rules": 0.1,
                   "update": 0.1}, 3, 0.02),
}


@pytest.mark.parametrize("mix", list(WORKLOAD_MIXES))
def test_seeded_workload_equals_reference(ctx, ref_ctx, mix):
    weights, update_rows, density = WORKLOAD_MIXES[mix]
    got = make_workload(ctx, 300, np.random.default_rng(24), mix=weights,
                        update_rows=update_rows, density=density)
    want = ref_serve.make_workload(ref_ctx, 300, np.random.default_rng(24), mix=weights,
                                   update_rows=update_rows, density=density)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


# -- parity with the reference: virtual-clock load runs -----------------------


def _recording(queue):
    """Wrap ``queue.submit`` to keep every ticket in submission order."""
    tickets = []
    submit = queue.submit

    def record(*args, **kw):
        ticket = submit(*args, **kw)
        tickets.append(ticket)
        return ticket

    queue.submit = record
    return tickets


def _virtual_run(pkg, engine, arrivals, events, cfg, updater=None, rules_index=None,
                 clock=None, repair=True):
    """One ``run_load`` on a virtual clock (start 50 s; dispatch costs no
    virtual time).  The reference's queue gets the harness's repair of
    its livelock unless ``repair`` is false."""
    clock, sleep = clock or _virtual_clock(50.0)[:2]
    queue = pkg.AdmissionQueue(engine, cfg, rules_index=rules_index, clock=clock)
    if pkg is ref_serve and repair:
        repair_livelock(queue)
    tickets = _recording(queue)
    slo_pkg = slo if pkg is serve else ref_slo
    rep = pkg.run_load(queue, arrivals, events, updater=updater, clock=clock, sleep=sleep,
                       slo=slo_pkg.SLO(latency_objective_s=0.003))
    return rep, tickets, queue


def _answers(tickets):
    out = []
    for t in tickets:
        parts = t.result if isinstance(t.result, tuple) else (t.result,)
        out.append((t.kind, t.shed, None if t.result is None else
                    [(np.asarray(p).dtype.str, np.asarray(p).tobytes()) for p in parts]))
    return out


LOAD_CASES = {
    # name: arrival process, qps, seconds, arrival kw, mix, AdmissionConfig kw
    # a depth under the slot count: partial batches, sheds at submit
    "poisson-default-mix": ("poisson", 300.0, 1.0, {}, None, {"max_wait_s": 0.01, "depth": 2}),
    # a long deadline: full batches dispatch inline between the deadlines
    "burst-with-rules": ("burst", 400.0, 1.0, {"factor": 4.0},
                         {"closure": 0.5, "topk": 0.2, "lookup": 0.1, "rules": 0.2},
                         {"max_wait_s": 0.05, "rules_k": 3, "rules_min_conf": 0.4,
                          "rules_rank_by": "lift"}),
}


@pytest.fixture(scope="module")
def ref_served(ref_ctx, intents, jax_reference):  # noqa: F811
    store = RefStore.build(ref_ctx, intents, plan=RefPlan.simulated(2, block_n=16))
    return store, RefEngine(store, RefConfig(slots=SLOTS, backend="jnp"))


@pytest.fixture(scope="module")
def rule_indexes(served, ref_served):
    port = rules.RuleIndex.build(rules.extract_bases(served[0], min_conf=0.4), device="cpu")
    ref = ref_rules.RuleIndex.build(ref_rules.extract_bases(ref_served[0], min_conf=0.4))
    return port, ref


@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_virtual_clock_load_equals_reference(case, ctx, ref_ctx, served, ref_served,
                                             rule_indexes):
    name, qps, seconds, kw, mix, cfg_kw = LOAD_CASES[case]
    rng, ref_rng = np.random.default_rng(24), np.random.default_rng(24)
    arrivals = serve.ARRIVALS[name](qps, seconds, rng, **kw)
    events = make_workload(ctx, len(arrivals), rng, mix=mix)
    ref_arrivals = ref_serve.ARRIVALS[name](qps, seconds, ref_rng, **kw)
    ref_events = ref_serve.make_workload(ref_ctx, len(ref_arrivals), ref_rng, mix=mix)
    port_index, ref_index = rule_indexes if mix and "rules" in mix else (None, None)
    rep, tickets, queue = _virtual_run(serve, served[1], arrivals, events,
                                       AdmissionConfig(**cfg_kw), rules_index=port_index)
    ref_rep, ref_tickets, ref_queue = _virtual_run(
        ref_serve, ref_served[1], ref_arrivals, ref_events,
        ref_serve.AdmissionConfig(**cfg_kw), rules_index=ref_index)
    assert rep.describe() == ref_rep.describe()
    assert _answers(tickets) == _answers(ref_tickets)
    assert rep.completed == rep.admitted == rep.submitted - rep.shed
    assert rep.submitted == len(arrivals)
    assert set(rep.by_kind) == set(mix or serve.DEFAULT_MIX)
    # the admission-side registry (virtual clock) renders to the same bytes
    assert to_openmetrics(queue.stats.registry) == ref_obs.to_openmetrics(
        ref_queue.stats.registry)
    if case == "poisson-default-mix":
        assert rep.shed > 0
    else:
        assert "full" in rep.dispatch_causes and "deadline" in rep.dispatch_causes


def _stalling_clock(limit=100_000):
    """A virtual clock that raises once it is read ``limit`` times in a row
    at one instant (a driver polling the same instant forever)."""
    t, same = [50.0], [0, None]

    def clock():
        if same[1] != t[0]:
            same[:] = [0, t[0]]
        same[0] += 1
        if same[0] > limit:
            raise RuntimeError(f"livelock: {limit} clock reads at t = {t[0]!r}")
        return t[0]

    return clock, lambda s: t.__setitem__(0, t[0] + s)


def test_deadline_on_the_rounding_edge_does_not_livelock(served, ref_served):
    """ROADMAP C3.  ``next_deadline_in`` computes ``(t + max_wait) - now``
    and ``poll`` tests ``now - t >= max_wait``; at t = 50.00134152250196
    the first is 0.0 while the second is false.  The reference's
    ``run_load`` then skips its sleep and polls the same virtual instant
    forever; the port's sleeps its 10 µs floor and goes on, and gives the
    repaired reference's report."""
    _, qe = served
    rng = np.random.default_rng(24)
    arrivals = poisson_arrivals(300.0, 1.0, rng)
    events = make_workload(qe.store.ctx, len(arrivals), rng)
    cfg = {"max_wait_s": 0.01, "depth": 2}
    with pytest.raises(RuntimeError, match="livelock"):
        _virtual_run(ref_serve, ref_served[1], arrivals, events,
                     ref_serve.AdmissionConfig(**cfg), clock=_stalling_clock(), repair=False)
    rep, _, _ = _virtual_run(serve, qe, arrivals, events, AdmissionConfig(**cfg),
                             clock=_stalling_clock())
    ref_rep, _, _ = _virtual_run(ref_serve, ref_served[1], arrivals, events,
                                 ref_serve.AdmissionConfig(**cfg), clock=_stalling_clock())
    assert rep.describe() == ref_rep.describe()
    assert rep.completed == rep.admitted == len(arrivals) - rep.shed


@pytest.fixture(scope="module")
def stream_contexts():
    ref = ref_datasets.load("mushroom", scale=0.01)[0]
    port = port_context(ref)
    return ref, port, np.stack(all_closures_batched(port))


def test_virtual_clock_load_with_updates_equals_reference(stream_contexts, jax_reference):  # noqa: F811
    """Streamed updates commit between micro-batches (mushroom at scale
    0.01, its full lattice, k = 2): the queries after each commit see the
    new snapshot, and the final snapshot equals the reference's."""
    ref_ctx_, ctx_, full = stream_contexts
    mix = {"closure": 0.6, "topk": 0.2, "lookup": 0.1, "update": 0.1}
    store = ConceptStore.build(ctx_, full, plan=ShardPlan.simulated(2), device="cpu")
    ref_store = RefStore.build(ref_ctx_, full, plan=RefPlan.simulated(2))
    rng, ref_rng = np.random.default_rng(24), np.random.default_rng(24)
    arrivals = poisson_arrivals(100.0, 0.5, rng)
    events = make_workload(ctx_, len(arrivals), rng, mix=mix, update_rows=2)
    ref_arrivals = ref_serve.poisson_arrivals(100.0, 0.5, ref_rng)
    ref_events = ref_serve.make_workload(ref_ctx_, len(ref_arrivals), ref_rng, mix=mix,
                                         update_rows=2)
    cfg = {"max_wait_s": 0.002}
    rep, tickets, _ = _virtual_run(
        serve, QueryEngine(store, QueryConfig(slots=SLOTS, backend="torch")), arrivals,
        events, AdmissionConfig(**cfg), updater=StreamUpdater(store))
    ref_rep, ref_tickets, _ = _virtual_run(
        ref_serve, RefEngine(ref_store, RefConfig(slots=SLOTS, backend="jnp")),
        ref_arrivals, ref_events, ref_serve.AdmissionConfig(**cfg),
        updater=RefUpdater(ref_store))
    assert rep.updates >= 1 and store.snapshot.version == rep.updates
    assert rep.describe() == ref_rep.describe()
    assert _answers(tickets) == _answers(ref_tickets)
    assert store.snapshot.n_concepts == ref_store.snapshot.n_concepts > len(full)
    assert store.snapshot.intents_np.tobytes() == np.asarray(
        ref_store.snapshot.intents_np).tobytes()


# -- parity with the reference: OpenMetrics, SLO and the gate -----------------


def _escaped_registry(pkg):
    r = _loaded_registry(pkg)
    r.counter("odd name!", 2, path='a\\b"c\nd')
    r.gauge("ratio", 0.1 + 0.2)
    r.gauge("big", 1e16)
    r.observe("service_s", 3.5e-3, kind="closure")
    r.observe("service_s", 12.0, kind="closure")
    r.counter("twice", 1)
    r.gauge("twice", 4)
    return r


@pytest.mark.parametrize("content", ["serve", "escaped"])
def test_openmetrics_text_byte_identical_to_reference(content):
    make = _loaded_registry if content == "serve" else _escaped_registry
    text = to_openmetrics(make(obs), help_text={"serve_e2e_s": 'end "to" end'})
    want = ref_obs.to_openmetrics(make(ref_obs), help_text={"serve_e2e_s": 'end "to" end'})
    assert text == want
    assert parse_openmetrics(text) == ref_obs.parse_openmetrics(want)


EVALUATE_CASES = [
    ({}, 1.0, 0.0, None),
    ({"latency_objective_s": 0.1, "latency_target": 0.99, "max_p99_s": 0.2}, 0.9, 0.05, 0.5),
    ({"latency_target": 1.0}, 0.97, 0.0, 0.01),
    ({"max_shed_rate": 0.0}, 0.995, 1e-7, None),
]


@pytest.mark.parametrize("case", range(len(EVALUATE_CASES)))
def test_slo_evaluate_equals_reference(case):
    kw, compliance, shed_rate, p99 = EVALUATE_CASES[case]
    got = evaluate(SLO(**kw), compliance=compliance, shed_rate=shed_rate, p99_s=p99)
    want = ref_slo.evaluate(ref_slo.SLO(**kw), compliance=compliance, shed_rate=shed_rate,
                            p99_s=p99)
    assert got == want
    assert SLO(**kw).describe() == ref_slo.SLO(**kw).describe()


def test_check_baselines_and_gate_equal_reference(tmp_path):
    artifact = {"headline": {"e2e": {"p99": 0.03}, "shed_rate": 0.03, "bit_identical": False,
                             "qps": "n/a"}}
    baseline = {"latency_s": {"headline.e2e.p99": 0.004, "headline.missing": 1.0},
                "rate": {"headline.shed_rate": 0.0},
                "exact": {"headline.bit_identical": True}}
    for ratio, slack in ((4.0, 0.02), (10.0, 0.05)):
        got = check_baselines(artifact, baseline, tolerance_ratio=ratio, rate_slack=slack)
        assert got == ref_slo.check_baselines(artifact, baseline, tolerance_ratio=ratio,
                                              rate_slack=slack)
    art = tmp_path / "BENCH_x.json"
    art.write_text(json.dumps(artifact))
    base = tmp_path / "baselines.json"
    base.write_text(json.dumps({"rate_slack": 0.05, "artifacts": {"BENCH_x.json": baseline}}))
    for kw in ({}, {"tolerance_ratio": 10.0}):
        outs = []
        for gate in (run_gate, ref_slo.run_gate):
            buf = io.StringIO()
            outs.append((gate([str(art), str(art)], str(base), out=buf, **kw),
                         buf.getvalue()))
        assert outs[0] == outs[1]
        assert outs[0][0] == 1


# -- the CLI -----------------------------------------------------------------


def _keys(d: dict) -> dict:
    return {k: _keys(v) if isinstance(v, dict) and k in ("queue", "stats", "slo") else None
            for k, v in d.items()}


def test_cli_serve_load_prints_the_reference_keys(tmp_path, capsys, jax_reference):  # noqa: F811
    argv = ["serve", "--dataset", "mushroom", "--scale", "0.01", "--parts", "2",
            "--min-support", "0.3", "--queries", "16", "--topk", "8", "--slots", "8",
            "--load-qps", "100", "--load-seconds", "0.5", "--max-wait-ms", "2",
            "--mix", "closure=0.5,topk=0.2,lookup=0.1,rules=0.1,update=0.1"]
    ref_dump, dump = tmp_path / "ref.txt", tmp_path / "port.txt"
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        ref_fca.main(argv + ["--backend", "jnp", "--metrics-dump", str(ref_dump)])
    want = json.loads(buf.getvalue())["serve_load"]
    capsys.readouterr()
    fca.main(argv + ["--backend", "torch", "--device", "cpu", "--metrics-dump", str(dump)])
    captured = capsys.readouterr()
    got = json.loads(captured.out)["serve_load"]
    assert "dropping 'update' from the load mix" in captured.err
    assert _keys(got) == _keys(want)
    assert got["mix"] == want["mix"] == {"closure": 0.5, "topk": 0.2, "lookup": 0.1,
                                         "rules": 0.1}
    assert got["submitted"] == want["submitted"] > 0
    assert got["completed"] == got["admitted"] == got["submitted"] - got["shed"]
    assert set(got["by_kind"]) == set(want["by_kind"])
    fams = parse_openmetrics(dump.read_text())
    ref_fams = ref_obs.parse_openmetrics(ref_dump.read_text())
    assert set(fams) == set(ref_fams)
    assert {"serve_queue_depth", "serve_e2e_seconds", "service_seconds"} <= set(fams)
    assert obs.export.main([str(dump)]) == 0


def test_cli_rejects_a_malformed_mix():
    with pytest.raises(SystemExit, match="expected kind=weight"):
        fca._parse_mix("closure=0.5,topk")
    with pytest.raises(SystemExit, match="non-numeric weight"):
        fca._parse_mix("closure=half")
    assert fca._parse_mix("closure=0.6, topk=0.4") == ref_fca._parse_mix("closure=0.6, topk=0.4")


GROUP_BODY = """
from repro_torch.launch import fca
try:
    fca.main(["serve", "--dataset", "mushroom", "--scale", "0.01", "--device", "cpu",
              "--load-qps", "10"])
    msg = None
except SystemExit as e:
    msg = str(e)
print(json.dumps(msg))
"""


def test_load_qps_is_refused_under_a_two_rank_group(tmp_path):
    outs = run_ranks(tmp_path, GROUP_BODY, world=2, timeout=120)
    assert len(outs) == 2 and outs[0] == outs[1]
    assert "--load-qps" in outs[0] and "2 ranks" in outs[0]
    assert "own clock" in outs[0] and "collectives" in outs[0]
