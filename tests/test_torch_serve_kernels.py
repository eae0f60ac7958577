"""K5 (contains top-k) and K6 (rules top-k) against the JAX package.

The port's plain versions — what the wrappers run for CPU tensors — are
held against the reference's Pallas kernels in interpret mode
(``contains_topk_call``, ``rules_topk_call``; slot counts that are
multiples of 8, which those kernels require) and against the reference's
jnp steps (``_topk_int`` over the same scores, and the rule step of a
``QueryEngine(backend="jnp")``) at every slot count.  Tolerance: exact —
ids and integer supports equal, float32 scores equal bit for bit, union
words equal.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py phase 3.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.kernels import serve as ref_serve
from repro_torch.kernels import serve as skern

from _torch_reference import jax_reference, random_bits, t, u32  # noqa: F401


def _topk_case(rng, S, C, W, k, n_concepts, *, ties=True, miss_all=False):
    intents = random_bits(rng, C, W, 0.6)
    gc = intents[rng.integers(0, C, size=S)] & random_bits(rng, S, W, 0.3)
    gc[0] = 0  # the empty query: every live concept contains it
    if miss_all:
        gc[:] = 0xFFFFFFFF
        intents &= np.uint32(0x7FFFFFFF)  # no intent holds bit 31
    hi = 3 if ties else 10_000
    supports = rng.integers(0, hi, size=C).astype(np.int32)  # support 0 included
    return gc, intents, supports, n_concepts


def _rules_case(rng, S, R, W, *, ties=True, miss_all=False):
    prem = random_bits(rng, R, W, 0.08)
    added = random_bits(rng, R, W, 0.2) & ~prem
    choices = [0.1, 0.7, 0.5, 1.0] if ties else rng.random(R)
    conf = rng.choice(np.asarray(choices, np.float32), size=R).astype(np.float32)
    conf[rng.random(R) < 0.2] = np.float32(0.7)  # exactly at a threshold
    metric = rng.choice(np.asarray([0.0, 0.25, 2.0, 1.0], np.float32), size=R).astype(
        np.float32) if ties else rng.random(R).astype(np.float32) * 3
    rid = rng.permutation(R).astype(np.int32)
    queries = random_bits(rng, S, W, 0.8)
    queries[0] = 0xFFFFFFFF  # every live premise fits
    if miss_all:
        queries[:] = 0
        prem |= np.uint32(1)  # no premise is empty
    return prem, added, conf, metric, rid, queries


def _port_topk(gc, intents, supports, n_concepts, k):
    ids, vals = skern.contains_topk(t(gc), t(intents), torch.from_numpy(supports), n_concepts,
                                    k=k)
    plain = skern.contains_topk_plain(t(gc), t(intents), torch.from_numpy(supports),
                                      n_concepts, k=k)
    assert torch.equal(ids, plain[0]) and torch.equal(vals, plain[1])
    return ids.numpy(), vals.numpy()


def _ref_topk_jnp(gc, intents, supports, n_concepts, k):
    """The reference's jnp post: the same scores through ``_topk_int``."""
    contains = np.all((gc[:, None, :] & ~intents[None, :, :]) == 0, axis=-1)
    valid = np.arange(intents.shape[0]) < n_concepts
    scores = np.where(contains & valid[None, :], supports[None, :], -1).astype(np.int32)
    ids, vals = ref_serve._topk_int(jnp.asarray(scores), k)
    return np.asarray(ids), np.asarray(vals)


TOPK_CASES = [
    # S, C, W, k, n_concepts
    (8, 1, 4, 1, 1),
    (8, 7, 5, 5, 7),
    (8, 7, 4, 64, 5),  # C < k: every slot past the hits is (-1, -1)
    (16, 100, 4, 5, 90),  # pad rows past n_concepts
    (64, 300, 5, 64, 299),
    (24, 64, 4, 5, 0),  # no live concept
]


@pytest.mark.parametrize("S,C,W,k,n_concepts", TOPK_CASES)
def test_contains_topk_plain_matches_pallas_interpret(S, C, W, k, n_concepts):
    rng = np.random.default_rng(S * 1000 + C + W + k)
    case = _topk_case(rng, S, C, W, k, n_concepts)
    want = ref_serve.contains_topk_call(*map(jnp.asarray, case[:3]), jnp.int32(n_concepts),
                                        k=k, interpret=True)
    got = _port_topk(*case, k)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("S,C,W,k,n_concepts", [
    (13, 7, 5, 5, 7),  # S not a multiple of 8: past the reference kernel
    (1, 40, 4, 3, 30),
    (37, 200, 4, 64, 200),
])
@pytest.mark.parametrize("ties", [True, False])
def test_contains_topk_plain_matches_reference_jnp_step(S, C, W, k, n_concepts, ties):
    rng = np.random.default_rng(S + C + k + ties)
    case = _topk_case(rng, S, C, W, k, n_concepts, ties=ties)
    got = _port_topk(*case, k)
    want = _ref_topk_jnp(*case, k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] >= -1).all() and ((got[0] == -1) == (got[1] == -1)).all()


def test_contains_topk_no_match_and_support_zero():
    rng = np.random.default_rng(3)
    gc, intents, supports, _ = _topk_case(rng, 8, 20, 4, 5, 20, miss_all=True)
    ids, vals = _port_topk(gc, intents, supports, 20, 5)
    assert (ids == -1).all() and (vals == -1).all()
    # a concept of support 0 is a hit (score 0 >= 0)
    zero = np.zeros(20, np.int32)
    ids, vals = _port_topk(np.zeros((8, 4), np.uint32), intents, zero, 20, 5)
    np.testing.assert_array_equal(ids, np.tile(np.arange(5, dtype=np.int32), (8, 1)))
    assert (vals == 0).all()


def _port_rules(case, n_rules, min_conf, k):
    prem, added, conf, metric, rid, queries = case
    args = (t(prem), t(added), torch.from_numpy(conf), torch.from_numpy(metric),
            torch.from_numpy(rid), n_rules, t(queries), min_conf)
    got = skern.rules_topk(*args, k=k)
    plain = skern.rules_topk_plain(*args, k=k)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    return got[0].numpy(), got[1].numpy(), u32(got[2])


def _assert_rules_equal(got, want):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    # float32 scores bit for bit
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  np.asarray(want[1]).astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]).astype(np.uint32))


RULES_CASES = [
    # S, R, W, k, n_rules
    (8, 1, 4, 1, 1),
    (8, 7, 5, 5, 7),
    (16, 100, 4, 64, 90),
    (64, 300, 5, 5, 250),
]


@pytest.mark.parametrize("S,R,W,k,n_rules", RULES_CASES)
@pytest.mark.parametrize("min_conf", [0.1, 0.7])
def test_rules_topk_plain_matches_pallas_interpret(S, R, W, k, n_rules, min_conf):
    rng = np.random.default_rng(S * 7 + R + W + k)
    case = _rules_case(rng, S, R, W)
    prem, added, conf, metric, rid, queries = case
    want = ref_serve.rules_topk_call(
        *map(jnp.asarray, (prem, added, conf, metric, rid)), jnp.int32(n_rules),
        jnp.asarray(queries), jnp.float32(min_conf), k=k, interpret=True)
    _assert_rules_equal(_port_rules(case, n_rules, min_conf, k), want)


@pytest.fixture(scope="module")
def ref_rules_step():
    """The reference engine's jnp rule step (``backend="jnp"``): it reads no
    store state, so a one-shard store over the paper context is enough."""
    from repro.core import all_closures, paper_context
    from repro.query import ConceptStore, QueryEngine
    from repro.query.engine import QueryConfig

    ctx = paper_context()
    store = ConceptStore.build(ctx, all_closures(ctx))
    return QueryEngine(store, QueryConfig(backend="jnp"))._rules_step


@pytest.mark.parametrize("S,R,W,k,n_rules", [(13, 7, 5, 5, 7), (1, 50, 4, 64, 50),
                                             (29, 200, 4, 5, 0)])
@pytest.mark.parametrize("ties", [True, False])
def test_rules_topk_plain_matches_reference_jnp_step(ref_rules_step, S, R, W, k, n_rules,
                                                     ties):
    rng = np.random.default_rng(S + R + k + ties)
    case = _rules_case(rng, S, R, W, ties=ties)
    prem, added, conf, metric, rid, queries = case
    for min_conf in (0.1, 0.7, 0.0):
        want = ref_rules_step(k)(*map(jnp.asarray, (prem, added, conf, metric, rid)),
                                 jnp.int32(n_rules), jnp.asarray(queries),
                                 jnp.float32(min_conf))
        _assert_rules_equal(_port_rules(case, n_rules, min_conf, k), want)


# K6 at the edges of its table split (chip_smoke.py's RULES_SPLIT_*, at CPU
# sizes): live counts beside 256-row tiles and powers of two, equal (metric,
# rule id) at positions far apart (the lower position wins: one pass's last
# winner then decides where the next pass starts), k past one pass of 64.
@pytest.mark.parametrize("live", [255, 256, 257, 511, 512, 513])
@pytest.mark.parametrize("k", [5, 65, 100])
def test_rules_topk_plain_matches_reference_jnp_step_at_the_split_edges(ref_rules_step,
                                                                         live, k):
    rng = np.random.default_rng(live * 7 + k)
    R, S, W = live + 3, 13, 4
    prem, added, conf, metric, rid, queries = _rules_case(rng, S, R, W)
    rid = rng.integers(0, 4, size=R).astype(np.int32)  # (metric, rid) ties everywhere
    far = [0, live // 2, live - 1]  # the best entry three times, far apart
    prem[far] = 0
    conf[far] = 1.0
    metric[far] = 3.0
    rid[far] = 1
    case = (prem, added, conf, metric, rid, queries)
    for min_conf in (0.1, 0.7):
        want = ref_rules_step(k)(*map(jnp.asarray, (prem, added, conf, metric, rid)),
                                 jnp.int32(live), jnp.asarray(queries), jnp.float32(min_conf))
        got = _port_rules(case, live, min_conf, k)
        _assert_rules_equal(got, want)
        assert (got[0][:, :3] == 1).all() and (got[1][:, :3] == 3.0).all()


def test_rules_topk_no_match_and_union_over_every_firing_rule():
    rng = np.random.default_rng(5)
    case = _rules_case(rng, 8, 30, 4, miss_all=True)
    ids, vals, union = _port_rules(case, 30, 0.0, 5)
    assert (ids == -1).all() and (vals == -1.0).all() and (union == 0).all()
    # k = 1: the union still ORs every firing rule, not only the top one
    prem, added, conf, metric, rid, _ = _rules_case(rng, 8, 30, 4)
    queries = np.full((8, 4), 0xFFFFFFFF, np.uint32)
    ids, vals, union = _port_rules((prem, added, conf, metric, rid, queries), 30, 0.0, 1)
    np.testing.assert_array_equal(union[0], np.bitwise_or.reduce(added, axis=0))
    lift0 = metric.copy()
    lift0[:] = 0.0  # a rule whose metric is 0 is a hit
    ids, vals, _ = _port_rules((prem, added, conf, lift0, rid, queries), 30, 0.0, 3)
    np.testing.assert_array_equal(ids[0], np.sort(rid)[:3])
    assert (vals == 0.0).all()


def test_min_conf_is_compared_in_float32():
    """0.7 is not a float32: a confidence of float32(0.7) passes a 0.7
    threshold (both round to the same float32), as in the reference."""
    prem = np.zeros((1, 4), np.uint32)
    added = np.array([[1, 0, 0, 0]], np.uint32)
    conf = np.array([np.float32(0.7)], np.float32)
    metric = conf.copy()
    rid = np.zeros(1, np.int32)
    queries = np.zeros((8, 4), np.uint32)
    ids, vals, union = _port_rules((prem, added, conf, metric, rid, queries), 1, 0.7, 1)
    assert (ids == 0).all() and (union[:, 0] == 1).all()
    assert float(np.float32(0.7)) < 0.7  # a float64 compare would drop the rule


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(
    seed=st.integers(0, 2**31 - 1),
    S=st.integers(1, 20),
    C=st.integers(1, 60),
    W=st.integers(1, 3),
    k=st.integers(1, 12),
    live=st.floats(0.0, 1.2),
    min_conf=st.sampled_from([0.0, 0.1, 0.5, 0.7, 1.0]),
)
def test_property_plain_versions_match_reference(seed, S, C, W, k, live, min_conf):
    rng = np.random.default_rng(seed)
    n_live = int(live * C)
    case = _topk_case(rng, S, C, W, k, n_live)
    got = _port_topk(*case, k)
    want = _ref_topk_jnp(*case, k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rcase = _rules_case(rng, S, C, W, ties=bool(seed % 2))
    prem, added, conf, metric, rid, queries = rcase
    # the reference kernel's own arithmetic, in numpy, at any S
    app = np.all((prem[None] & ~queries[:, None]) == 0, axis=-1)
    ok = app & (conf >= np.float32(min_conf))[None] & (np.arange(C) < n_live)[None]
    union = np.bitwise_or.reduce(np.where(ok[:, :, None], added[None], 0), axis=1)
    got = _port_rules(rcase, n_live, min_conf, k)
    np.testing.assert_array_equal(got[2], union.astype(np.uint32))
    order = [sorted(np.nonzero(ok[s])[0], key=lambda r: (-metric[r], rid[r], r))
             for s in range(S)]
    for s in range(S):
        top = order[s][:k]
        want_ids = [int(rid[r]) for r in top] + [-1] * (k - len(top))
        want_vals = [float(metric[r]) for r in top] + [-1.0] * (k - len(top))
        assert got[0][s].tolist() == want_ids
        assert got[1][s].tolist() == want_vals


def test_supports_serve_has_no_shape_limit(monkeypatch):
    """The bound change against the reference: its ``supports_serve``
    refuses a table above 2**22 cells or a slot count that is not a
    multiple of 8; the port has no such gate, and its kernel backend sends
    top-k and rule queries at such a slot count to the K5 and K6
    wrappers (the torch backend to neither)."""
    from repro_torch.core import ClosureEngine, mrcbo, paper_context
    from repro_torch.query import ConceptStore, QueryConfig, QueryEngine
    from repro_torch.rules import RuleIndex, extract_bases

    assert not ref_serve.supports_serve("kernel", (1 << 20) + 3, 5, 1000)
    assert not ref_serve.supports_serve("kernel", 8, 4, 12)
    calls = []
    for name in ("contains_topk", "rules_topk"):
        def spy(*args, _real=getattr(skern, name), _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(skern, name, spy)
    ctx = paper_context()
    store = ConceptStore.build(ctx, mrcbo(ctx, ClosureEngine(ctx, device="cpu")).intents,
                               device="cpu")
    index = RuleIndex.build(extract_bases(store, min_conf=0.5), device="cpu")
    queries = random_bits(np.random.default_rng(0), 20, ctx.W, 0.3)
    for backend, want in (("kernel", ["contains_topk"] * 2 + ["rules_topk"] * 2),
                          ("torch", [])):
        calls.clear()
        eng = QueryEngine(store, QueryConfig(slots=12, backend=backend))
        eng.topk_batch(queries, k=3)
        eng.rules_batch(index, queries, k=3, min_conf=0.5)
        assert calls == want, backend


@pytest.mark.parametrize("k", [0])
def test_k_outside_the_kernels_range_raises(k):
    z = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="k="):
        skern.contains_topk(z, z, torch.zeros(8, dtype=torch.int32), 8, k=k)
    f = torch.zeros(8, dtype=torch.float32)
    with pytest.raises(ValueError, match="k="):
        skern.rules_topk(z, z, f, f, torch.zeros(8, dtype=torch.int32), 8, z, 0.5, k=k)


@pytest.mark.parametrize("kind", ["topk", "rules"])
def test_k_past_one_pass_matches_the_reference_kernel_backend(jax_reference, kind):
    """k = 100, more than one launch's PASS_K: the reference's
    ``backend="kernel"`` (its Pallas kernels in interpret mode, whose k
    selection passes have no bound) against the port's kernel backend on
    the CPU, which runs the plain versions of K5 and K6.  The synthetic
    context's full lattice (1751 concepts) for top-k; its iceberg at
    ``min_support=6`` and its bases for rules, with all-ones queries so that
    every live rule fires.  Exact: ids, supports, float32 scores and union
    words equal."""
    import repro.core as ref_core
    import repro.rules as ref_rules
    from repro.query import ConceptStore as RefStore
    from repro.query import QueryEngine as RefEngine
    from repro.query.engine import QueryConfig as RefConfig
    from repro_torch import rules
    from repro_torch.interop import basis_from_arrays
    from repro_torch.query import ConceptStore, QueryConfig, QueryEngine

    from _torch_reference import port_context

    k = 100
    assert k > skern.PASS_K
    ctx_r = ref_core.FormalContext.synthetic(60, 24, 0.35, seed=42)
    ctx = port_context(ctx_r)
    intents = np.stack(ref_core.mrcbo(ctx_r, ref_core.ClosureEngine(ctx_r, backend="jnp")).intents)
    min_support = 6 if kind == "rules" else None
    ref = RefStore.build(ctx_r, intents, min_support=min_support)
    port = ConceptStore.build(ctx, intents, min_support=min_support, device="cpu")
    ref_eng = RefEngine(ref, RefConfig(slots=8, backend="kernel"))
    eng = QueryEngine(port, QueryConfig(slots=8, backend="kernel"))
    rng = np.random.default_rng(7)
    if kind == "topk":
        q = random_bits(rng, 20, ctx.W, 0.1)
        q[0] = 0  # every concept contains the empty query: k hits
        want = ref_eng.topk_batch(q, k=k)
        got = eng.topk_batch(q, k=k)
        assert (got[0][0] >= 0).all()
    else:
        basis = ref_rules.extract_bases(ref, min_conf=0.5)
        ref_index = ref_rules.RuleIndex.build(basis)
        combined = basis.combined()
        index = rules.RuleIndex.build(basis_from_arrays(
            *(getattr(combined, f) for f in ("premise", "added", "support", "confidence",
                                             "lift")),
            basis.n_implications, n_objects=basis.n_objects, n_attrs=basis.n_attrs,
            min_conf=basis.min_conf), device="cpu")
        q = np.full((12, ctx.W), 0xFFFFFFFF, np.uint32)
        q[6:] = random_bits(rng, 6, ctx.W, 0.6)
        want = ref_eng.rules_batch(ref_index, q, k=k, min_conf=0.5, rank_by="lift")
        got = eng.rules_batch(index, q, k=k, min_conf=0.5, rank_by="lift")
        assert (got[0][:6] >= 0).all()  # every live rule fires on the all-ones query
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("bad,error", [
    ({"supports": torch.zeros(8, dtype=torch.int64)}, TypeError),
    ({"supports": torch.zeros(7, dtype=torch.int32)}, ValueError),
    ({"intents": torch.zeros((8, 5), dtype=torch.int32)}, ValueError),
    ({"gc": torch.zeros((8, 4), dtype=torch.int64)}, TypeError),
    ({"intents": torch.zeros((4, 8), dtype=torch.int32).t()}, ValueError),
], ids=["supports-int64", "supports-length", "W-mismatch", "gc-int64", "non-contiguous"])
def test_contains_topk_refuses_bad_operands(bad, error):
    args = {"gc": torch.zeros((8, 4), dtype=torch.int32),
            "intents": torch.zeros((8, 4), dtype=torch.int32),
            "supports": torch.zeros(8, dtype=torch.int32)}
    args.update(bad)
    with pytest.raises(error):
        skern.contains_topk(args["gc"], args["intents"], args["supports"], 8, k=5)


@pytest.mark.parametrize("bad,error", [
    ({"conf": torch.zeros(8, dtype=torch.float64)}, TypeError),
    ({"rid": torch.zeros(8, dtype=torch.int64)}, TypeError),
    ({"added": torch.zeros((7, 4), dtype=torch.int32)}, ValueError),
    ({"queries": torch.zeros((8, 3), dtype=torch.int32)}, ValueError),
], ids=["conf-f64", "rid-int64", "added-rows", "queries-W"])
def test_rules_topk_refuses_bad_operands(bad, error):
    args = {"prem": torch.zeros((8, 4), dtype=torch.int32),
            "added": torch.zeros((8, 4), dtype=torch.int32),
            "conf": torch.zeros(8, dtype=torch.float32),
            "metric": torch.zeros(8, dtype=torch.float32),
            "rid": torch.zeros(8, dtype=torch.int32),
            "queries": torch.zeros((8, 4), dtype=torch.int32)}
    args.update(bad)
    with pytest.raises(error):
        skern.rules_topk(args["prem"], args["added"], args["conf"], args["metric"],
                         args["rid"], 8, args["queries"], 0.5, k=5)


def test_cpu_tensors_launch_nothing():
    skern.contains_topk.launches = skern.rules_topk.launches = 0
    z = torch.zeros((8, 4), dtype=torch.int32)
    skern.contains_topk(z, z, torch.zeros(8, dtype=torch.int32), 8, k=5)
    f = torch.zeros(8, dtype=torch.float32)
    skern.rules_topk(z, z, f, f, torch.zeros(8, dtype=torch.int32), 8, z, 0.5, k=5)
    assert skern.contains_topk.launches == 0 and skern.rules_topk.launches == 0
