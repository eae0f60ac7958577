"""Rule bases, the rule index and rule serving against the JAX package.

``dg_basis`` and ``luxenburger_from_snapshot`` (through ``extract_bases``
over stores at k ∈ {1, 8}) against the reference's, array by array: the
premises, added sets and supports equal, the float32 confidences and lifts
equal bit for bit; both against the brute-force host oracles on the paper
context; ``RuleIndex`` tables against the reference's; ``rules_batch``
answers against the reference engine's on one rule table carried across by
``interop.basis_from_arrays``; and the ``serve`` and ``rules`` CLI
subcommands on the CPU against the reference CLI's JSON.  The reference's
shard steps need the jax-0.9 binding of the ``jax_reference`` fixture.
Tolerance: exact equality.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest

import repro.core as ref_core
from repro.data import fca_datasets as ref_datasets
from repro.dist.shardplan import ShardPlan as RefPlan
from repro.launch import fca as ref_fca
from repro.query import ConceptStore as RefStore
from repro.query import QueryEngine as RefEngine
from repro.query.engine import QueryConfig as RefConfig
from repro import rules as ref_rules
from repro.rules.index import rule_query_mix as ref_rule_query_mix
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.interop import basis_from_arrays
from repro_torch.launch import fca
from repro_torch.query import ConceptStore, QueryConfig, QueryEngine
from repro_torch import rules

from _torch_reference import jax_reference, port_context, u32  # noqa: F401

RULE_FIELDS = ("premise", "added", "support", "confidence", "lift")
FAMILIES = {
    # name: (reference context, min_support of the family, None = full)
    "paper": (ref_core.paper_context, None),
    "synthetic": (lambda: ref_core.FormalContext.synthetic(60, 24, 0.35, seed=42), 6),
    "mushroom-0.01": (lambda: ref_datasets.load("mushroom", scale=0.01)[0], 20),
}
_cache: dict = {}


@pytest.fixture(autouse=True)
def _binding(jax_reference):  # noqa: F811
    """Every test of this module may run a reference round."""
    yield


def _family(name):
    if name not in _cache:
        make, min_support = FAMILIES[name]
        ctx = make()
        res = ref_core.mrcbo(ctx, ref_core.ClosureEngine(ctx, backend="jnp"),
                             min_support=min_support)
        _cache[name] = (ctx, port_context(ctx), np.stack(res.intents))
    return _cache[name]


def _bases(name, k, min_conf):
    key = (name, k, min_conf)
    if key not in _cache:
        ctx_r, ctx, intents = _family(name)
        ref = RefStore.build(ctx_r, intents, plan=RefPlan.simulated(k))
        port = ConceptStore.build(ctx, intents, plan=ShardPlan.simulated(k), device="cpu")
        _cache[key] = (ref, port, ref_rules.extract_bases(ref, min_conf=min_conf),
                       rules.extract_bases(port, min_conf=min_conf))
    return _cache[key]


def assert_rules_equal(got, want, fields=RULE_FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        # bytes, so float32 equality is bit for bit
        assert g.tobytes() == w.tobytes(), f


@pytest.mark.parametrize("min_conf", [0.0, 0.5])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("name", ["paper", "synthetic", "mushroom-0.01"])
def test_bases_match_reference(name, k, min_conf):
    _, _, want, got = _bases(name, k, min_conf)
    assert_rules_equal(got.implications, want.implications)
    assert_rules_equal(got.partial, want.partial)
    assert got.describe() == want.describe()
    assert got.n_implications > 0


@pytest.mark.parametrize("name", ["paper", "synthetic"])
def test_dg_basis_matches_reference_directly(name):
    ctx_r, ctx, intents = _family(name)
    sup = RefStore.build(ctx_r, intents).snapshot.supports_np
    want = ref_rules.dg_basis(intents, sup, ctx.n_attrs)  # |O| from the top concept
    got = rules.dg_basis(intents, sup, ctx.n_attrs, device="cpu")
    assert_rules_equal(got, want)


def test_bases_match_the_host_oracles_on_the_paper_context():
    ctx_r, ctx, intents = _family("paper")
    _, port, _, got = _bases("paper", 1, 0.0)
    oracle = rules.dg_basis_host(intents, ctx.n_attrs)
    assert_rules_equal(oracle, ref_rules.dg_basis_host(intents, ctx.n_attrs))
    assert_rules_equal(got.implications, oracle, ("premise", "added", "confidence"))
    snap = port.snapshot
    lux = rules.luxenburger_host(snap.intents_np, snap.supports_np, ctx.n_objects,
                                 n_attrs=ctx.n_attrs, device="cpu")
    assert_rules_equal(lux, ref_rules.luxenburger_host(snap.intents_np, snap.supports_np,
                                                       ctx.n_objects, n_attrs=ctx.n_attrs))
    assert_rules_equal(got.partial, lux)
    assert (got.partial.confidence < 1).all() and (got.implications.confidence == 1).all()


def test_luxenburger_from_snapshot_matches_reference_at_a_threshold():
    ref, port, _, _ = _bases("synthetic", 8, 0.5)
    ctx = port.ctx
    for min_conf in (0.1, 0.7):
        want = ref_rules.luxenburger_from_snapshot(ref.snapshot, ctx.n_objects,
                                                   min_conf=min_conf, n_attrs=ctx.n_attrs)
        got = rules.luxenburger_from_snapshot(port.snapshot, ctx.n_objects,
                                              min_conf=min_conf, n_attrs=ctx.n_attrs)
        assert_rules_equal(got, want)
        assert (got.confidence >= np.float32(min_conf)).all()


def _indexes(name, k, min_conf):
    ref, port, want, got = _bases(name, k, min_conf)
    ref_index = ref_rules.RuleIndex.build(want, plan=ref.plan)
    combined = want.combined()
    carried = basis_from_arrays(
        *(getattr(combined, f) for f in RULE_FIELDS), want.n_implications,
        n_objects=want.n_objects, n_attrs=want.n_attrs, min_conf=want.min_conf)
    return ref, port, ref_index, rules.RuleIndex.build(carried, device="cpu"), got


@pytest.mark.parametrize("name", ["paper", "synthetic"])
def test_rule_index_matches_reference(name):
    _, port, ref_index, carried, got = _indexes(name, 8, 0.5)
    own = rules.RuleIndex.build(got, plan=port.plan, device="cpu")
    for index in (carried, own):
        assert index.describe() == ref_index.describe()
        for f in ("premise", "added", "support", "confidence", "lift", "rule_id"):
            want = np.asarray(getattr(ref_index, f))
            have = getattr(index, f)
            have = u32(have) if want.dtype == np.uint32 else have.numpy()
            assert have.tobytes() == want.tobytes(), f
        for f in ("premise_np", "added_np", "support_np", "confidence_np", "lift_np"):
            assert getattr(index, f).tobytes() == getattr(ref_index, f).tobytes(), f


@pytest.mark.parametrize("backend", ["torch", "kernel", "matmul"])
@pytest.mark.parametrize("name", ["paper", "synthetic", "mushroom-0.01"])
def test_rules_batch_matches_reference(name, backend):
    ref, port, ref_index, index, _ = _indexes(name, 8, 0.5)
    ctx = port.ctx
    q = rules.rule_query_mix(ctx, index, 70, np.random.default_rng(0))
    np.testing.assert_array_equal(
        q, ref_rule_query_mix(ref.ctx, ref_index, 70, np.random.default_rng(0)))
    ref_eng = RefEngine(ref, RefConfig(slots=16, backend="jnp"))
    eng = QueryEngine(port, QueryConfig(slots=16, backend=backend))
    for rank_by in ("confidence", "lift"):
        for k, min_conf in ((5, 0.5), (1, 0.7), (64, 0.0)):
            want = ref_eng.rules_batch(ref_index, q, k=k, min_conf=min_conf, rank_by=rank_by)
            got = eng.rules_batch(index, q, k=k, min_conf=min_conf, rank_by=rank_by)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert (got[0][: len(q) // 2, 0] >= 0).all()  # the premise half always fires
    stats = {key: eng.describe()["stats"][key] for key in ("queries", "micro_batches",
                                                           "by_type", "collective_rounds")}
    assert stats == {key: ref_eng.describe()["stats"][key] for key in stats}


# -- the CLI subcommands on the CPU --------------------------------------------


def _ref_cli(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_fca.main(argv)
    return json.loads(buf.getvalue())


def _port_cli(argv, capsys) -> dict:
    fca.main(argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out)


WALLS = {"mine_wall_s", "store_build_s", "query_wall_s", "queries_per_s",
         "update_commit_s", "basis_extract_s", "rule_query_wall_s", "rule_queries_per_s"}


def _compare_cli(got, want, backend):
    assert set(want) <= set(got), set(want) - set(got)
    for key, w in want.items():
        if key in WALLS or key in ("plan", "backend"):
            continue
        g = got[key]
        if key == "store":
            g, w = dict(g, plan=None), dict(w, plan=None)
        if key == "update" and w is not None:
            g, w = dict(g, stage_wall_s=0), dict(w, stage_wall_s=0)
        if key == "query_stats":
            g = {k: g[k] for k in INT_STATS}
            w = {k: w[k] for k in INT_STATS}
        assert g == w, key
    assert got["backend"] == backend and got["device"] == "cpu"


INT_STATS = ("queries", "micro_batches", "collective_rounds", "modeled_comm_bytes",
             "by_type", "reduce_rounds", "auto_hop_bytes", "hop_calibrated")


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_cli_serve_matches_reference(capsys, backend):
    argv = ["serve", "--dataset", "mushroom", "--scale", "0.01", "--parts", "2",
            "--reduce", "auto", "--queries", "40", "--topk", "12", "--slots", "16",
            "--updates", "4", "--algorithm", "mrcbo"]
    want = _ref_cli(argv + ["--backend", "jnp"])
    got = _port_cli(argv + ["--backend", backend], capsys)
    _compare_cli(got, want, backend)
    assert got["closure_hit_rate"] == 1.0 and got["post_update_hit_rate"] == 1.0
    assert got["post_update_version"] == 1


def test_cli_serve_on_an_iceberg_skips_the_update(capsys):
    argv = ["serve", "--dataset", "mushroom", "--scale", "0.01", "--parts", "8",
            "--queries", "40", "--topk", "8", "--slots", "16", "--min-support", "0.2",
            "--local-prune"]
    want = _ref_cli(argv + ["--backend", "jnp"])
    got = _port_cli(argv + ["--backend", "torch"], capsys)
    _compare_cli(got, want, "torch")
    assert got["update"] is None and got["post_update_version"] == 0
    assert got["closure_hit_rate"] < 1.0


@pytest.mark.parametrize("rank_by", ["confidence", "lift"])
def test_cli_rules_matches_reference(capsys, rank_by):
    argv = ["rules", "--dataset", "mushroom", "--scale", "0.01", "--parts", "8",
            "--min-support", "0.25", "--min-conf", "0.5", "--rule-queries", "50",
            "--slots", "16", "--rank-by", rank_by, "--local-prune"]
    want = _ref_cli(argv + ["--backend", "jnp"])
    got = _port_cli(argv + ["--backend", "kernel"], capsys)
    _compare_cli(got, want, "kernel")
    assert got["basis"]["implications"] > 0 and got["rule_hit_rate"] > 0.4
