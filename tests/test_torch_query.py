"""The port's concept store and query engine against the JAX package.

``ConceptStore`` at k ∈ {1, 2, 8} object shards (simulated plans, with
all-ones pad rows in the last shards) against the reference store built
from the same numpy intents: the canonical intent order, supports, the
hash keys, ``max_bucket`` / ``probe``, the four packed order tables, the
object-sharded extent table and ``build(min_support=)``.  Every
``QueryEngine`` query kind and the integer fields of
``describe()["stats"]`` against the reference ``QueryEngine(backend="jnp")``
for the port's backends under ``allgather``, ``rsag`` and ``auto``; a
4-rank gloo process group against the simulated plan.  The reference's
shard steps need the jax-0.9 binding of the ``jax_reference`` fixture.
Tolerance: exact equality of every word, id, count and byte.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core as ref_core
from repro.core import lattice as ref_lattice
from repro.data import fca_datasets as ref_datasets
from repro.dist.shardplan import ShardPlan as RefPlan
from repro.query import ConceptStore as RefStore
from repro.query import QueryEngine as RefEngine
from repro.query import store as ref_store
from repro.query.engine import QueryConfig as RefConfig
from repro_torch.core import bitset, lattice
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.query import ConceptStore, QueryConfig, QueryEngine, store
from repro_torch.query.store import host_supports

from _torch_reference import jax_reference, port_context, random_bits, t, u32  # noqa: F401
from test_torch_collectives import run_ranks

CONTEXTS = {
    "paper": ref_core.paper_context,
    "synthetic": lambda: ref_core.FormalContext.synthetic(60, 24, 0.35, seed=42),
    "mushroom-0.01": lambda: ref_datasets.load("mushroom", scale=0.01)[0],
}
INT_STATS = ("queries", "micro_batches", "collective_rounds", "modeled_comm_bytes",
             "by_type", "reduce_rounds", "auto_hop_bytes", "hop_calibrated")
_cache: dict = {}


@pytest.fixture(autouse=True)
def _binding(jax_reference):  # noqa: F811
    """Every test of this module may run a reference round."""
    yield


def _family(name: str):
    """(reference context, port context, full intent family), cached."""
    if name not in _cache:
        ctx = CONTEXTS[name]()
        eng = ref_core.ClosureEngine(ctx, backend="jnp")
        intents = np.stack(ref_core.mrcbo(ctx, eng).intents)
        _cache[name] = (ctx, port_context(ctx), intents)
    return _cache[name]


def _stores(name, k, block_n=256, impl="rsag", min_support=None):
    """(reference store, port store) over one family and plan, cached: the
    tests read them and never stage an update."""
    key = (name, k, block_n, impl, min_support)
    if key not in _cache:
        _cache[key] = _build_stores(name, k, block_n, impl, min_support)
    return _cache[key]


def _build_stores(name, k, block_n, impl, min_support):
    ctx_r, ctx, intents = _family(name)
    ref = RefStore.build(ctx_r, intents, plan=RefPlan.simulated(k, reduce_impl=impl,
                                                                 block_n=block_n),
                         min_support=min_support)
    port = ConceptStore.build(ctx, intents, plan=ShardPlan.simulated(k, reduce_impl=impl,
                                                                     block_n=block_n),
                              min_support=min_support, device="cpu")
    return ref, port


def assert_snapshots_equal(a, b):
    """A reference snapshot and a port snapshot, field by field."""
    assert (a.version, a.n_concepts, a.cap, a.max_bucket, a.probe) == (
        b.version, b.n_concepts, b.cap, b.max_bucket, b.probe)
    np.testing.assert_array_equal(b.intents_np, a.intents_np)
    assert b.intents_np.dtype == np.uint32
    np.testing.assert_array_equal(b.supports_np, a.supports_np)
    for name in ("intents", "sub_rows", "sup_rows", "children_rows", "parents_rows",
                 "ext_cols"):
        want = np.asarray(getattr(a, name)).astype(np.uint32)
        got = u32(getattr(b, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(b.supports.numpy(), np.asarray(a.supports))
    np.testing.assert_array_equal(b.skeys.numpy(), np.asarray(a.skeys))


# -- device primitives --------------------------------------------------------


def test_popcount_pack_and_canonical_order_match_reference():
    rng = np.random.default_rng(0)
    x = random_bits(rng, 50, 5, 0.4)
    np.testing.assert_array_equal(store.popcount_torch(t(x)).numpy(),
                                  np.asarray(ref_store.popcount_jnp(jnp.asarray(x))))
    dense = rng.random((7, 96)) < 0.5
    np.testing.assert_array_equal(u32(store.pack_bool_torch(torch.from_numpy(dense))),
                                  np.asarray(ref_store.pack_bool_jnp(jnp.asarray(dense))))
    np.testing.assert_array_equal(store.canonical_order(x, 160),
                                  ref_store.canonical_order(x, 160))


@pytest.mark.parametrize("name", ["paper", "synthetic"])
def test_order_tables_are_the_lattice_covering(name):
    """The order tables against the host lattice's subset matrix and
    covering relation, both the port's numpy copy and the reference's."""
    ctx_r, ctx, intents = _family(name)
    _, port = _stores(name, 1)
    snap = port.snapshot
    C = snap.n_concepts
    leq = lattice.subset_matrix(snap.intents_np, ctx.n_attrs)
    np.testing.assert_array_equal(leq, ref_lattice.subset_matrix(snap.intents_np,
                                                                 ctx.n_attrs))
    cover = lattice.covering_matmul(leq)
    np.testing.assert_array_equal(cover, ref_lattice.covering_matmul(leq))
    unpack = lambda rows: bitset.unpack_bits(u32(rows)[:C], snap.cap)[:, :C]  # noqa: E731
    np.testing.assert_array_equal(unpack(snap.children_rows), cover.T)
    np.testing.assert_array_equal(unpack(snap.parents_rows), cover)
    np.testing.assert_array_equal(unpack(snap.sub_rows), leq & ~np.eye(C, dtype=bool))
    lat = lattice.build_lattice(ctx, list(intents))
    ref_lat = ref_lattice.build_lattice(ctx_r, list(intents))
    np.testing.assert_array_equal(lat.intents, ref_lat.intents)
    assert [list(map(int, c)) for c in lat.children] == [
        list(map(int, c)) for c in ref_lat.children]


def test_host_supports_match_the_store_and_the_reference():
    ctx_r, ctx, intents = _family("synthetic")
    _, port = _stores("synthetic", 2)
    snap = port.snapshot
    np.testing.assert_array_equal(host_supports(ctx, snap.intents_np), snap.supports_np)
    np.testing.assert_array_equal(host_supports(ctx, snap.intents_np),
                                  ref_store.host_supports(ctx_r, snap.intents_np))


# -- the store ------------------------------------------------------------------


@pytest.mark.parametrize("block_n", [8, 256])
@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("name", ["paper", "synthetic"])
def test_store_matches_reference(name, k, block_n):
    """At k > 1 the all-ones pad rows sit in the last shards: a body that
    read every simulated shard as shard 0 would count them as objects."""
    ref, port = _stores(name, k, block_n)
    assert port.n_pad == ref.n_pad and port.N_padded == ref.N_padded
    if k > 1:
        assert port.n_pad > 0
    assert_snapshots_equal(ref.snapshot, port.snapshot)
    ctx = port.ctx
    np.testing.assert_array_equal(port.snapshot.supports_np,
                                  host_supports(ctx, port.snapshot.intents_np))
    want = ref.describe()
    got = port.describe()
    for key in ("objects", "attrs", "version", "concepts", "cap", "max_bucket"):
        assert got[key] == want[key], key


def test_store_on_mushroom_matches_reference():
    ref, port = _stores("mushroom-0.01", 8)
    assert port.snapshot.n_concepts == 4440 and port.snapshot.cap == 8192
    assert_snapshots_equal(ref.snapshot, port.snapshot)


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("min_support", [3, 20])
def test_store_build_min_support_matches_reference(k,  # noqa: F811
                                                   min_support):
    ref, port = _stores("synthetic", k, min_support=min_support)
    assert_snapshots_equal(ref.snapshot, port.snapshot)
    assert (port.snapshot.supports_np >= min_support).all()
    ice_ref = _stores("synthetic", k)[0].iceberg(min_support + 5)
    ice = port.iceberg(min_support + 5)
    assert_snapshots_equal(ice_ref.snapshot, ice.snapshot)


def test_global_row_index_reads_every_simulated_shard():
    plan = ShardPlan.simulated(4)
    rows = plan.place_rows(np.zeros((4 * 3, 2), np.uint32), "cpu")
    idx = plan.global_row_index(rows)
    np.testing.assert_array_equal(idx.numpy(), np.arange(12).reshape(4, 3))
    assert plan.shard_index() == 0  # the trap global_row_index avoids


def test_spmd_out_shard_keeps_sharded_outputs():
    plan = ShardPlan.simulated(4)
    rows = plan.place_rows(np.arange(8, dtype=np.uint32)[:, None], "cpu")

    def body(rows_local, scale):
        return rows_local * scale, (rows_local.sum((-2, -1)) * 0 + 7)

    sharded, rep = plan.spmd(body, n_rep=1, out_shard=(True, False))(rows, 2)
    assert tuple(sharded.shape) == (4, 2, 1) and int(rep) == 7
    np.testing.assert_array_equal(sharded.reshape(-1).numpy(), np.arange(8) * 2)
    with pytest.raises(ValueError, match="entries"):
        plan.spmd(body, n_rep=1, out_shard=(True,))(rows, 2)


# -- the query engine -----------------------------------------------------------


def _query_mix(ctx, n, seed):
    rng = np.random.default_rng(seed)
    base = ctx.rows[rng.integers(0, ctx.n_objects, size=n)]
    keep = bitset.pack_bool(rng.random((n, ctx.n_attrs)) < 0.25, ctx.W)
    q = base & keep
    q[0] = 0
    return q


def run_queries(eng, ctx, seed=0, slots_mult=2.5):
    """Every query kind once, in a fixed order; returns every answer."""
    n = int(eng.cfg.slots * slots_mult)
    q = _query_mix(ctx, n, seed)
    out = {}
    out["closure"] = eng.closure_batch(q)
    out["topk"] = eng.topk_batch(q[: n // 2], k=5)
    out["topk64"] = eng.topk_batch(q[:9], k=64)
    ids = out["closure"][2]
    hit = np.concatenate([ids[ids >= 0][:12], [-1, 10**6]]).astype(np.int32)
    out["lookup"] = eng.lookup_batch(out["closure"][0])
    for kind in ("children", "parents", "supers", "subs"):
        out[kind] = getattr(eng, kind)(hit)
    out["extents"] = eng.extents_batch(hit)
    out["empty"] = eng.closure_batch(np.zeros((0, ctx.W), np.uint32))
    out["stats"] = {k: eng.describe()["stats"][k] for k in INT_STATS}
    return out


def assert_answers_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if key == "stats":
            assert got[key] == want[key]
            continue
        g, w = got[key], want[key]
        g = g if isinstance(g, (tuple, list)) else [g]
        w = w if isinstance(w, (tuple, list)) else [w]
        assert len(g) == len(w), key
        for x, y in zip(g, w):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=key)
            assert np.asarray(x).dtype == np.asarray(y).dtype, key


@pytest.mark.parametrize("impl", ["allgather", "rsag", "auto"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("backend", ["torch", "matmul"])
def test_query_engine_matches_reference(backend, k, impl):
    ref, port = _stores("synthetic", k, impl=impl)
    want = run_queries(RefEngine(ref, RefConfig(slots=16, backend="jnp")), port.ctx)
    got = run_queries(QueryEngine(port, QueryConfig(slots=16, backend=backend)), port.ctx)
    assert_answers_equal(got, want)
    assert got["stats"]["queries"] > 0
    if k > 1:
        assert got["stats"]["modeled_comm_bytes"] > 0


def test_kernel_backend_on_cpu_runs_the_plain_versions():
    """``backend="kernel"`` on CPU tensors: the wrappers run their plain
    versions, so the answers are the reference's and nothing launches."""
    from repro_torch import kernels

    ref, port = _stores("paper", 8, impl="auto")
    want = run_queries(RefEngine(ref, RefConfig(slots=8, backend="jnp")), port.ctx)
    kernels.reset_launches()
    got = run_queries(QueryEngine(port, QueryConfig(slots=8, backend="kernel")), port.ctx)
    assert_answers_equal(got, want)
    assert all(k.launches == 0 for k in kernels.KERNELS)


def test_query_engine_on_mushroom_matches_reference():
    ref, port = _stores("mushroom-0.01", 8)
    want = run_queries(RefEngine(ref, RefConfig(slots=64, backend="jnp")), port.ctx,
                       slots_mult=1.5)
    got = run_queries(QueryEngine(port, QueryConfig(slots=64, backend="torch")), port.ctx,
                      slots_mult=1.5)
    assert_answers_equal(got, want)
    assert (got["closure"][2] >= 0).all()  # a full lattice: every closure is an intent


def test_query_engine_validates_its_config():
    _, port = _stores("paper", 1)
    with pytest.raises(ValueError, match="backend"):
        QueryEngine(port, QueryConfig(backend="jnp"))
    eng = QueryEngine(port, QueryConfig(backend="torch"))
    with pytest.raises(ValueError, match="rank_by"):
        eng.rules_batch(None, np.zeros((1, 1), np.uint32), rank_by="support")


# -- a real process group: 4 gloo ranks on the CPU ----------------------------

GROUP_BODY = """
import numpy as np
import repro_torch.core as core
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.query import ConceptStore, QueryConfig, QueryEngine

ctx = core.FormalContext.synthetic(60, 24, 0.35, seed=42)
intents = np.stack(core.mrcbo(ctx, core.ClosureEngine(ctx, device="cpu")).intents)
out = {}
for impl in ("allgather", "rsag"):
    plan = ShardPlan.over_group(None, "cpu", reduce_impl=impl, block_n=8)
    st = ConceptStore.build(ctx, intents, plan=plan)
    eng = QueryEngine(st, QueryConfig(slots=16, backend="torch"))
    rng = np.random.default_rng(0)
    q = ctx.rows[rng.integers(0, 60, 40)] & np.uint32(0x5555F)
    c, s, i = eng.closure_batch(q)
    ti, tv = eng.topk_batch(q, k=5)
    ext = eng.extents_batch(i)
    out[impl] = {"closure": c.tolist(), "supports": s.tolist(), "ids": i.tolist(),
                 "topk": ti.tolist(), "extents": ext.tolist(),
                 "ext_cols": list(st.snapshot.ext_cols.shape),
                 "supports_np": st.snapshot.supports_np.tolist(),
                 "stats": {k: eng.describe()["stats"][k] for k in
                           ("modeled_comm_bytes", "reduce_rounds", "collective_rounds")}}
print(json.dumps(out))
"""


def test_process_group_ranks_serve_the_simulated_answers(tmp_path):
    outs = run_ranks(tmp_path, GROUP_BODY, world=4)
    ctx = port_context(ref_core.FormalContext.synthetic(60, 24, 0.35, seed=42))
    _, _, intents = _family("synthetic")
    for impl in ("allgather", "rsag"):
        plan = ShardPlan.simulated(4, reduce_impl=impl, block_n=8)
        st = ConceptStore.build(ctx, intents, plan=plan, device="cpu")
        eng = QueryEngine(st, QueryConfig(slots=16, backend="torch"))
        rng = np.random.default_rng(0)
        q = ctx.rows[rng.integers(0, 60, 40)] & np.uint32(0x5555F)
        c, s, i = eng.closure_batch(q)
        ti, _ = eng.topk_batch(q, k=5)
        ext = eng.extents_batch(i)
        for rank, out in enumerate(outs):
            got = out[impl]
            assert got["closure"] == c.tolist() and got["supports"] == s.tolist(), rank
            assert got["ids"] == i.tolist() and got["topk"] == ti.tolist(), rank
            assert got["extents"] == ext.tolist(), rank
            assert got["supports_np"] == st.snapshot.supports_np.tolist(), rank
            assert got["ext_cols"] == list(st.snapshot.ext_cols.shape[1:]), rank
            assert got["stats"] == {k: eng.describe()["stats"][k] for k in got["stats"]}
