"""The port's tracer and metrics registry against the JAX package's.

Histograms, the registry, the stats base and the trace validator and
rollup are pure Python in both packages: the same inputs go through both
and must give equal outputs (percentiles, bucket edges, exports, error
types and messages).  The spans the port records around mining and
serving: a traced mine bit-identical to an untraced one, round spans
tagged with the plan, the span names of the reference's rollup, each
package's ``validate_trace`` accepting the other's saved trace, the query
engine's micro-batch telemetry on an injected clock equal to the
reference's, and the ``torch.profiler`` device trace on the CPU.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.context as ref_context
import repro.obs as ref_obs
from repro.dist.shardplan import ShardPlan as RefPlan
from repro.query import ConceptStore as RefStore
from repro.query import QueryEngine as RefQueryEngine
from repro.query.engine import QueryConfig as RefQueryConfig
import repro_torch.core as core
import repro_torch.obs as obs
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.obs.trace import NOOP, _NULL_SPAN
from repro_torch.query import ConceptStore, QueryConfig, QueryEngine, StreamUpdater

from _torch_reference import jax_reference, port_context  # noqa: F401


@pytest.fixture(scope="module")
def ref_ctx():
    return ref_context.FormalContext.synthetic(60, 14, 0.3, seed=11)


@pytest.fixture(scope="module")
def ctx(ref_ctx):
    return port_context(ref_ctx)


def _both(fn):
    """``fn(pkg)`` for the port's and the reference's obs package."""
    return fn(obs), fn(ref_obs)


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e).__name__, str(e)
    return None


# -- histogram / registry / stats base ----------------------------------------

SAMPLES = {
    "linear": list(np.linspace(0.001, 0.1, 1000)),
    "underflow": [5e-7, 2e-7, 0.004, 0.0, 1e-6],
    "single": [2.5],
    "spread": list(np.random.default_rng(0).lognormal(-6, 2, 500)),
}


@pytest.mark.parametrize("name", list(SAMPLES))
def test_histogram_matches_reference(name):
    def read(pkg):
        h = pkg.Histogram()
        for v in SAMPLES[name]:
            h.record(float(v))
        return {
            "percentiles": h.percentiles((0, 1, 50, 90, 95, 99, 99.9, 100)),
            "p50": h.percentile(50), "edges": h.bucket_edges(), "summary": h.summary(),
            "underflow": h.underflow, "count": h.count,
            "below": [h.fraction_below(x) for x in (1e-6, 1e-3, 0.05, 3.0)],
        }

    got, want = _both(read)
    assert got == want
    if name == "linear":  # relative error within the 2**(1/8) bucket factor
        for q, expect in ((50, 0.0505), (95, 0.0950), (99, 0.0990)):
            assert abs(got["percentiles"][f"p{q}"] - expect) / expect < 0.10


def test_empty_histogram_matches_reference():
    got, want = _both(lambda pkg: (pkg.Histogram().percentile(50), pkg.Histogram().summary()))
    assert got == want == (0.0, want[1])


def test_registry_cap_labels_and_export_match_reference():
    def fill(pkg):
        r = pkg.Registry(max_label_sets=4)
        for i in range(10):
            r.counter("hits", qid=str(i))
        for i in range(6):
            r.observe("lat_s", 0.001 * (i + 1), qid=str(i))
        r.counter("rounds", 1, impl="rsag")
        r.counter("rounds", 2, impl="rsag")
        r.gauge("parts", 4)
        r2 = pkg.Registry(max_label_sets=1)
        r2.counter("a")
        r2.counter("b")
        fams = [(n, t, [(lab, v if isinstance(v, float) else v.summary()) for lab, v in s])
                for n, t, s in r.families()]
        return r.export(), r2.export(), fams

    got, want = _both(fill)
    assert got == want
    export = got[0]
    assert export["hits{overflow=true}"] == 6
    assert export["labels_overflow_total{metric=hits}"] == 6
    assert export["rounds{impl=rsag}"] == 3
    json.dumps(export)


def test_stats_base_latency_view_and_publish_match_reference():
    def fill(pkg):
        st = pkg.StatsBase()
        st.record_reduce("allgather")
        st.record_reduce("allgather")
        st.record_reduce("rsag", 3)
        for v in (0.002, 0.004, 0.0001):
            st.observe_latency("round", v)
        st.observe_latency("micro_batch", 0.03)
        return dataclasses.asdict(st), st.publish()

    got, want = _both(fill)
    assert got == want
    assert "_registry" not in got[0]
    assert set(got[0]["latency_percentiles"]["round"]) == {"p50", "p95", "p99"}
    assert got[1]["reduce_rounds{impl=allgather}"] == 2


def test_stats_tiers_inherit_the_stats_base():
    from repro_torch.core.engine import EngineStats
    from repro_torch.query.engine import QueryStats

    for cls in (EngineStats, QueryStats):
        st = cls()
        assert isinstance(st, obs.StatsBase) and isinstance(st, obs.ScheduleCensus)
        st.observe_latency("x", 0.5)
        assert dataclasses.asdict(st)["latency_percentiles"]["x"]["p50"] == 0.5


# -- tracer export, validation and rollup ---------------------------------------


def _record(pkg):
    tr = pkg.Tracer()
    with tr.span("a", x=1):
        with tr.span("a/b"):
            tr.instant("mark", k=2)
        with tr.span("a/c") as sp:
            sp.set(outcome="done")
    tr.begin_async("round", 7, algo="x")
    with tr.span("dispatch"):
        pass
    tr.end_async("round", 7, outcome="adopt")
    for i in range(3):
        with tr.span(f"mine/round[{i}]"):
            with tr.span(f"mine/round[{i}]/filter"):
                pass
    return tr


def test_trace_round_trips_and_validates_in_both_packages():
    for pkg in (obs, ref_obs):
        loaded = json.loads(json.dumps(_record(pkg).to_dict()))
        got, want = obs.validate_trace(loaded), ref_obs.validate_trace(loaded)
        assert got == want
        assert want["spans"] == 10 and want["async_spans"] == 1 and want["max_depth"] == 2
        ts = [e["ts"] for e in loaded["traceEvents"]]
        assert ts == sorted(ts)
        ends = {e["name"]: e.get("args") for e in loaded["traceEvents"] if e["ph"] == "E"}
        assert ends["a/c"] == {"outcome": "done"}
    port = _record(obs).to_dict()
    ref = _record(ref_obs).to_dict()
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in port["traceEvents"]]
    assert strip == [{k: v for k, v in e.items() if k != "ts"} for e in ref["traceEvents"]]
    assert port["otherData"]["tracer"] == "repro_torch.obs"


def test_span_rollup_and_overlaps_equal_the_reference_on_the_same_events():
    events = _record(ref_obs).to_dict()
    assert obs.span_rollup(events["traceEvents"]) == ref_obs.span_rollup(events["traceEvents"])
    assert obs.async_overlaps(events) == ref_obs.async_overlaps(events)
    roll = obs.span_rollup(events["traceEvents"])
    assert roll["mine/round"]["count"] == roll["mine/round/filter"]["count"] == 3
    assert set(roll["mine/round"]) >= {"count", "total_s", "p50_s", "p95_s", "p99_s"}


def test_save_closes_leaked_spans(tmp_path):
    for pkg in (obs, ref_obs):
        tr = pkg.Tracer()
        tr.span("leaked").__enter__()
        path = tmp_path / f"{pkg.__name__}.json"
        tr.save(str(path))
        loaded = json.loads(path.read_text())
        assert obs.validate_trace(loaded) == ref_obs.validate_trace(loaded)


BASE = {"pid": 0, "tid": 0, "cat": "host"}
MALFORMED = {
    "not-a-dict": [],
    "no-events": {"events": []},
    "events-not-a-list": {"traceEvents": {}},
    "event-not-an-object": {"traceEvents": [1]},
    "missing-key": {"traceEvents": [{"name": "a", "ph": "B", "pid": 0, "tid": 0}]},
    "unknown-phase": {"traceEvents": [dict(BASE, name="a", ph="Q", ts=1.0)]},
    "negative-ts": {"traceEvents": [dict(BASE, name="a", ph="B", ts=-1.0)]},
    "unclosed": {"traceEvents": [dict(BASE, name="a", ph="B", ts=1.0)]},
    "bad-nest": {"traceEvents": [dict(BASE, name="a", ph="B", ts=1.0),
                                 dict(BASE, name="b", ph="B", ts=2.0),
                                 dict(BASE, name="a", ph="E", ts=3.0)]},
    "orphan-end": {"traceEvents": [dict(BASE, name="a", ph="E", ts=1.0)]},
    "not-monotone": {"traceEvents": [dict(BASE, name="a", ph="B", ts=5.0),
                                     dict(BASE, name="a", ph="E", ts=1.0)]},
    "orphan-async": {"traceEvents": [dict(BASE, name="r", ph="e", ts=1.0, id=3, cat="round")]},
    "unclosed-async": {"traceEvents": [dict(BASE, name="r", ph="b", ts=1.0, id=3,
                                            cat="round")]},
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_validate_trace_rejects_what_the_reference_rejects(case):
    got = _error(lambda: obs.validate_trace(MALFORMED[case]))
    want = _error(lambda: ref_obs.validate_trace(MALFORMED[case]))
    assert got == want and got is not None and got[0] in ("ValueError", "TypeError")


def test_noop_tracer_is_the_allocation_free_default():
    assert obs.current() is NOOP
    assert NOOP.span("x", a=1) is _NULL_SPAN
    with NOOP.span("x") as sp:
        sp.set(outcome="dropped")
    NOOP.instant("x")
    NOOP.begin_async("x", 1)
    NOOP.end_async("x", 1)
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        assert obs.current() is tr
        with obs.use_tracer(None):
            assert obs.current() is NOOP
    assert obs.current() is NOOP
    obs.set_tracer(tr)
    assert obs.current() is tr
    obs.set_tracer(None)
    assert obs.current() is NOOP


def test_profiler_annotations_keep_the_trace_well_formed():
    tr = obs.Tracer(profiler_annotations=True)
    with tr.span("outer", k=1) as sp:
        with tr.span("inner"):
            pass
        sp.set(done=True)
    assert obs.validate_trace(tr.to_dict())["spans"] == 2


def test_device_trace_on_the_cpu(tmp_path):
    assert obs.start_device_trace(str(tmp_path / "dev"))
    assert not obs.start_device_trace(str(tmp_path / "other"))  # one session at a time
    ctx = core.paper_context()
    core.mrcbo(ctx, core.ClosureEngine(ctx, device="cpu"))
    assert obs.stop_device_trace()
    assert not obs.stop_device_trace()
    exported = json.loads((tmp_path / "dev" / obs.trace.DEVICE_TRACE_FILE).read_text())
    assert exported["traceEvents"]


# -- spans around mining ---------------------------------------------------------


def _mine_fingerprint(ctx, tracer, plan):
    eng = core.ClosureEngine(ctx, plan=plan, device="cpu")
    with obs.use_tracer(tracer):
        res = core.mrcbo(ctx, eng)
    s = eng.stats
    return {
        "intents": [y.tobytes() for y in res.intents],
        "iterations": res.n_iterations,
        "closure_calls": s.closure_calls,
        "closures_computed": s.closures_computed,
        "modeled_comm_bytes": s.modeled_comm_bytes,
        "reduce_rounds": dict(s.reduce_rounds),
        "h2d": (s.h2d_transfers, s.h2d_bytes),
        "d2h": (s.d2h_transfers, s.d2h_bytes),
    }


@pytest.mark.parametrize("cand_parts", [1, 2])
def test_traced_mine_bit_identical_to_untraced(ctx, cand_parts):
    plan = ShardPlan.simulated(2, cand_parts=cand_parts, block_n=64, max_batch=32)
    untraced = _mine_fingerprint(ctx, None, plan)
    traced = _mine_fingerprint(ctx, obs.Tracer(), plan)
    assert traced == untraced
    assert {y for y in untraced["intents"]} == {
        y.tobytes() for y in core.all_closures(ctx)}


@pytest.mark.parametrize("cand_parts", [1, 2])
def test_mine_trace_names_and_tags_match_the_reference(jax_reference, ref_ctx, ctx,  # noqa: F811
                                                       cand_parts):
    """The same mine traced by each package: the same span names with the
    same counts (one round span a round, its phases a chunk), round spans
    tagged with the plan, and each package validating the other's trace."""
    traces = []
    for pkg, c, plan in (
        (core, ctx, ShardPlan.simulated(2, cand_parts=cand_parts, block_n=64, max_batch=32)),
        (ref_core, ref_ctx, RefPlan.simulated(2, cand_parts=cand_parts, block_n=64,
                                              max_batch=32)),
    ):
        kw = {"device": "cpu"} if pkg is core else {"backend": "jnp"}
        eng = pkg.ClosureEngine(c, plan=plan, **kw)
        tr = (obs if pkg is core else ref_obs).Tracer()
        with (obs if pkg is core else ref_obs).use_tracer(tr):
            pkg.mrcbo(c, eng)
            pkg.mrganter_plus(c, pkg.ClosureEngine(c, plan=plan, **kw), local_prune=True)
        assert sum(eng.stats.reduce_rounds.values()) == eng.stats.closure_calls
        assert "round" in eng.stats.latency_percentiles
        traces.append(json.loads(json.dumps(tr.to_dict())))
    port, ref = traces
    for trace in traces:
        assert obs.validate_trace(trace) == ref_obs.validate_trace(trace)
        assert not obs.async_overlaps(trace)
    counts = [{n: r["count"] for n, r in obs.span_rollup(tr["traceEvents"]).items()}
              for tr in traces]
    assert counts[0] == counts[1]
    for name in ("mine/mrcbo", "mine/mrganter_plus", "mine/round", "mine/round/expand",
                 "mine/round/dispatch", "mine/round/allreduce", "mine/round/filter",
                 "engine/closure"):
        assert counts[0][name] >= 1, name
    args = [[e.get("args") for e in tr["traceEvents"]
             if e["ph"] == "B" and e["name"].startswith("mine/round")] for tr in traces]
    assert args[0] == args[1]
    first = args[0][0]
    assert first["n_parts"] == 2 and first["cand_parts"] == cand_parts
    assert first["mode"] == "sync" and first["plan"] == "simulated"


# -- spans and telemetry around serving -------------------------------------------


def _ticks():
    state = {"t": 0.0}

    def clock():
        state["t"] += 0.001
        return state["t"]

    return clock


def test_query_telemetry_on_an_injected_clock_matches_reference(jax_reference, ref_ctx,  # noqa: F811
                                                                ctx):
    """Both engines on one tick-per-read clock: equal latency views and
    registry exports; one span per micro-batch in the port's trace."""
    rng = np.random.default_rng(0)
    queries = ref_ctx.rows[rng.integers(0, ref_ctx.n_objects, 40)]
    intents = ref_core.all_closures_batched(ref_ctx)
    ref_store = RefStore.build(ref_ctx, intents, plan=RefPlan.simulated(2, block_n=16))
    ref_qe = RefQueryEngine(ref_store, RefQueryConfig(slots=8, backend="jnp"), clock=_ticks())
    store = ConceptStore.build(ctx, [np.asarray(y, np.uint32) for y in intents],
                               plan=ShardPlan.simulated(2, block_n=16), device="cpu")
    qe = QueryEngine(store, QueryConfig(slots=8, backend="torch"), clock=_ticks())
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        for eng in (qe, ref_qe):
            closed, _, ids = eng.closure_batch(queries)
            eng.topk_batch(queries[:12], k=3)
            eng.lookup_batch(closed)
            eng.extents_batch(np.arange(5, dtype=np.int32))
    got, want = dataclasses.asdict(qe.stats), dataclasses.asdict(ref_qe.stats)
    assert got == want
    assert set(got["latency_percentiles"]["micro_batch"]) == {"p50", "p95", "p99"}
    assert qe.stats.registry.export() == ref_qe.stats.registry.export()
    roll = tr.rollup()
    assert roll["query/micro_batch"]["count"] == got["micro_batches"]
    assert obs.validate_trace(tr.to_dict())


def test_stream_spans_and_clock(ctx):
    intents = core.all_closures(ctx)
    store = ConceptStore.build(ctx, intents, plan=ShardPlan.simulated(2, block_n=16),
                               device="cpu")
    upd = StreamUpdater(store, clock=_ticks())
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        receipt = upd.apply(ctx.rows[:3])
    assert receipt.stage_wall_s == pytest.approx(0.001)
    roll = tr.rollup()
    assert roll["stream/stage"]["count"] == roll["stream/commit"]["count"] == 1
    end = [e for e in tr.events if e["ph"] == "E" and e["name"] == "stream/stage"][0]
    assert end["args"]["version"] == 1 and end["args"]["n_new_objects"] == 3


def test_cli_trace_validates_in_both_packages(tmp_path, capsys):
    from repro_torch.launch import fca

    trace, stats = tmp_path / "t.json", tmp_path / "s.json"
    fca.main(["serve", "--dataset", "mushroom", "--scale", "0.003", "--parts", "2",
              "--cand-shards", "2", "--algorithm", "mrcbo", "--queries", "24", "--topk", "8",
              "--slots", "8", "--updates", "2", "--device", "cpu", "--backend", "torch",
              "--trace", str(trace), "--stats-json", str(stats)])
    out = json.loads(capsys.readouterr().out)
    saved = json.loads(trace.read_text())
    assert obs.validate_trace(saved) == ref_obs.validate_trace(saved)
    assert json.loads(stats.read_text()) == out
    assert out["trace_path"] == str(trace)
    assert out["span_rollup"] == obs.span_rollup(saved["traceEvents"])
    assert set(out["query_stats"]["latency_percentiles"]["micro_batch"]) == {"p50", "p95", "p99"}
    assert obs.trace.main([str(trace)]) == 0


def test_cli_device_trace_exports_or_fails(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import fca

    argv = ["mine", "--dataset", "mushroom", "--scale", "0.003", "--parts", "2",
            "--device", "cpu", "--backend", "torch", "--device-trace", str(tmp_path / "dev")]
    fca.main(argv)
    out = json.loads(capsys.readouterr().out)
    assert out["device_trace_path"] == str(tmp_path / "dev" / obs.trace.DEVICE_TRACE_FILE)
    assert json.loads((tmp_path / "dev" / obs.trace.DEVICE_TRACE_FILE).read_text())["traceEvents"]
    monkeypatch.setattr(fca, "start_device_trace", lambda log_dir: False)
    with pytest.raises(SystemExit, match="did not start"):
        fca.main(argv)
    monkeypatch.undo()
    monkeypatch.setattr(fca, "stop_device_trace", lambda: obs.stop_device_trace() and False)
    with pytest.raises(SystemExit, match="failed"):
        fca.main(argv)
    assert not obs.stop_device_trace()  # no session left running


@pytest.mark.parametrize("flag", [["--mesh"], ["--pod", "2"]])
def test_cli_mesh_flags_need_a_process_group(flag):
    from repro_torch.launch import fca

    with pytest.raises(SystemExit, match="need a torch.distributed group"):
        fca.main(["mine", "--dataset", "mushroom", "--scale", "0.003", "--parts", "2",
                  "--device", "cpu", "--backend", "torch", *flag])
