"""Streaming updates against the JAX package.

``StreamUpdater`` (stage / commit / apply) at k ∈ {1, 8} object shards and
``row_slack`` ∈ {0, 64}: the successor snapshot after one and after three
commits equals the reference updater's, field by field, the receipt's
counts equal, and the grown intent set equals the host Godin insertion and
a remining of the grown context.  The host half (``core/incremental.py``)
against the reference's.  The reference's shard steps need the jax-0.9
binding of the ``jax_reference`` fixture.  Tolerance: exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest

import repro.core as ref_core
from repro.core import incremental as ref_inc
from repro.dist.shardplan import ShardPlan as RefPlan
from repro.query import ConceptStore as RefStore
from repro.query import QueryEngine as RefEngine
from repro.query import StreamUpdater as RefUpdater
from repro.query.engine import QueryConfig as RefConfig
import repro_torch.core as core
from repro_torch.core import bitset, incremental
from repro_torch.dist.shardplan import ShardPlan
from repro_torch.query import ConceptStore, QueryConfig, QueryEngine, StreamUpdater
from repro_torch.query.stream import _grow_intents_dev

from _torch_reference import jax_reference, port_context, t, u32  # noqa: F401
from test_torch_query import assert_snapshots_equal

RECEIPT = ("n_new_objects", "n_intersections", "n_concepts_before", "n_concepts_after",
           "version")


def _batches(ctx, seed, n_batches, K=4):
    rng = np.random.default_rng(seed)
    return [bitset.pack_bool(rng.random((K, ctx.n_attrs)) < 0.35, ctx.W)
            for _ in range(n_batches)]


# -- the host half ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_incremental_host_matches_reference(seed):
    ctx_r = ref_core.FormalContext.synthetic(20, 12, 0.4, seed=seed)
    ctx = port_context(ctx_r)
    intents = np.stack(ref_core.all_closures(ctx_r))
    rows = _batches(ctx, seed, 1, K=5)[0]
    np.testing.assert_array_equal(incremental.row_intersections(rows),
                                  ref_inc.row_intersections(rows))
    got_ctx, got = incremental.add_objects(ctx, intents, rows)
    want_ctx, want = ref_inc.add_objects(ctx_r, intents, rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_ctx.rows, want_ctx.rows)
    _, seq = incremental.add_objects_sequential(ctx, intents, rows)
    np.testing.assert_array_equal(seq, got)
    _, one = incremental.add_object(ctx, intents, rows[0])
    np.testing.assert_array_equal(one, ref_inc.add_object(ctx_r, intents, rows[0])[1])
    remined = np.unique(np.stack(core.all_closures(got_ctx)), axis=0)
    np.testing.assert_array_equal(np.unique(got, axis=0), remined)
    with pytest.raises(ValueError, match="above n_attrs"):
        incremental.add_object(ctx, intents, np.full((1,), 0xFFFFFFFF, np.uint32))


def test_grow_step_equals_the_host_godin_insertion():
    """The chunked device grow step gives the host insertion's distinct set
    whatever the chunk size."""
    import repro_torch.query.stream as stream

    ctx = core.FormalContext.synthetic(40, 20, 0.4, seed=3)
    intents = np.stack(core.all_closures(ctx))
    rows = _batches(ctx, 3, 1, K=4)[0]
    P = incremental.row_intersections(rows)
    Cb = 1 << int(np.ceil(np.log2(intents.shape[0])))
    buf = np.full((Cb, ctx.W), 0xFFFFFFFF, np.uint32)
    buf[: intents.shape[0]] = intents
    Pb = np.zeros((P.shape[0] + 3, ctx.W), np.uint32)  # 3 pad rows (all-zero sets)
    Pb[: P.shape[0]] = P
    want = incremental.add_objects(ctx, intents, rows)[1]
    for chunk in (1 << 20, 64, 7):
        stream.GROW_CHUNK_ROWS, old = chunk, stream.GROW_CHUNK_ROWS
        try:
            uniq, n = _grow_intents_dev(t(buf), intents.shape[0], t(Pb), P.shape[0])
        finally:
            stream.GROW_CHUNK_ROWS = old
        got = u32(uniq[: int(n)])
        assert int(n) == want.shape[0]
        assert {r.tobytes() for r in got} == {r.tobytes() for r in want}


# -- the updater ----------------------------------------------------------------


@pytest.mark.parametrize("row_slack", [0, 64])
@pytest.mark.parametrize("k", [1, 8])
def test_stream_updater_matches_reference(jax_reference, k, row_slack):  # noqa: F811
    ctx_r = ref_core.FormalContext.synthetic(60, 24, 0.35, seed=42)
    ctx = port_context(ctx_r)
    intents = np.stack(ref_core.all_closures(ctx_r))
    ref = RefStore.build(ctx_r, intents, plan=RefPlan.simulated(k, block_n=8))
    port = ConceptStore.build(ctx, intents, plan=ShardPlan.simulated(k, block_n=8),
                              device="cpu")
    ref_up, up = RefUpdater(ref, row_slack=row_slack), StreamUpdater(port, row_slack=row_slack)
    assert up.row_quantum == ref_up.row_quantum
    ref_eng = RefEngine(ref, RefConfig(slots=16, backend="jnp"))
    eng = QueryEngine(port, QueryConfig(slots=16, backend="torch"))
    queries = ctx.rows[:20] & np.uint32(0x00FF00FF)
    for i, rows in enumerate(_batches(ctx, 7, 3), start=1):
        if i == 2:  # stage + commit by hand; the others through apply()
            want = ref_up.stage(rows)
            got = up.stage(rows)
            assert port.snapshot.version == i - 1  # the active one keeps serving
            ref_up.commit()
            up.commit()
        else:
            want, got = ref_up.apply(rows), up.apply(rows)
        assert {f: getattr(got, f) for f in RECEIPT} == {f: getattr(want, f) for f in RECEIPT}
        assert (port.n_pad, port.N_padded) == (ref.n_pad, ref.N_padded)
        np.testing.assert_array_equal(u32(port.rows), np.asarray(ref.rows).astype(np.uint32))
        if i in (1, 3):
            assert_snapshots_equal(ref.snapshot, port.snapshot)
            closures = eng.closure_batch(queries)
            for a, b in zip(closures, ref_eng.closure_batch(queries)):
                np.testing.assert_array_equal(a, b)
            assert (eng.lookup_batch(closures[0]) >= 0).all()
    grown_ctx, grown = incremental.add_objects(ctx, intents, np.concatenate(
        _batches(ctx, 7, 3)))
    assert {r.tobytes() for r in port.snapshot.intents_np} == {r.tobytes() for r in grown}
    assert port.ctx.n_objects == grown_ctx.n_objects == 72


def test_stage_refuses_bad_rows_and_commit_needs_a_stage():
    ctx = core.paper_context()
    port = ConceptStore.build(ctx, core.all_closures(ctx), device="cpu")
    up = StreamUpdater(port)
    with pytest.raises(ValueError, match="packed uint32"):
        up.stage(np.zeros((2, ctx.W + 1), np.uint32))
    with pytest.raises(ValueError, match="above n_attrs"):
        up.stage(np.full((1, ctx.W), 0xFFFFFFFF, np.uint32))
    with pytest.raises(RuntimeError, match="no staged update"):
        up.commit()
