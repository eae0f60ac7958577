"""Host layer of the port against the JAX package: datasets, contexts,
bitsets, the two-level hash, the lectic twins and the row-ordering
primitives.  Every comparison is exact (integers and bitsets)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.context as ref_context
import repro.core.frontier as ref_frontier
import repro.core.hashindex as ref_hashindex
import repro.core.lectic as ref_lectic
import repro.data.fca_datasets as ref_datasets
from repro.core import closebyone as ref_cbo
from repro.core import nextclosure as ref_nc
from repro_torch.core import bitset, closebyone, frontier, hashindex, lectic, nextclosure
from repro_torch.core.context import FormalContext, paper_context
from repro_torch.data import fca_datasets

from _torch_reference import port_context, random_bits, t, u32


@pytest.mark.parametrize(
    "n_objects,n_attrs,density,seed",
    [(60, 24, 0.35, 42), (7, 33, 0.5, 0), (100, 64, 0.1, 3), (9, 1, 0.9, 5)],
)
def test_synthetic_rows_byte_identical(n_objects, n_attrs, density, seed):
    ref = ref_context.FormalContext.synthetic(n_objects, n_attrs, density, seed=seed)
    port = FormalContext.synthetic(n_objects, n_attrs, density, seed=seed)
    assert port.rows.tobytes() == ref.rows.tobytes()
    assert (port.n_objects, port.n_attrs, port.W) == (ref.n_objects, ref.n_attrs, ref.W)
    assert port.attr_mask().tobytes() == ref.attr_mask().tobytes()
    for multiple in (8, 256):
        (pr, pn), (rr, rn) = port.padded_rows(multiple), ref.padded_rows(multiple)
        assert pn == rn and pr.tobytes() == rr.tobytes()


@pytest.mark.parametrize(
    "name,scale,seed",
    [("mushroom", 0.01, 0), ("mushroom", 0.05, 1), ("anon-web", 0.001, 0),
     ("census-income", 0.0005, 2)],
)
def test_load_rows_byte_identical(name, scale, seed):
    ref, ref_spec = ref_datasets.load(name, scale=scale, seed=seed)
    port, spec = fca_datasets.load(name, scale=scale, seed=seed)
    assert port.rows.tobytes() == ref.rows.tobytes()
    assert (spec.n_objects, spec.n_attrs, spec.synthetic) == (
        ref_spec.n_objects, ref_spec.n_attrs, ref_spec.synthetic)
    assert spec.density == ref_spec.density


def test_full_scale_mushroom_shape_matches_reference():
    ref, _ = ref_datasets.load("mushroom", scale=1.0)
    port, _ = fca_datasets.load("mushroom", scale=1.0)
    assert (port.n_objects, port.n_attrs, port.W) == (8124, 125, 4)
    assert port.rows.tobytes() == ref.rows.tobytes()


def test_paper_context_identical():
    ref, port = ref_context.paper_context(), paper_context()
    assert port.rows.tobytes() == ref.rows.tobytes()
    assert port.attr_names == ref.attr_names and port.obj_names == ref.obj_names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracles_match_reference(seed):
    ref = ref_context.FormalContext.synthetic(30, 12, 0.4, seed=seed)
    port = port_context(ref)
    ref_all = [y.tobytes() for y in ref_nc.all_closures(ref)]
    assert [y.tobytes() for y in nextclosure.all_closures(port)] == ref_all
    assert [y.tobytes() for y in nextclosure.all_closures_batched(port)] == ref_all
    rc, pc = ref_cbo.close_by_one(ref), closebyone.close_by_one(port)
    assert [y.tobytes() for y in pc.intents] == [y.tobytes() for y in rc.intents]
    assert (pc.n_iterations, pc.n_closures_computed) == (
        rc.n_iterations, rc.n_closures_computed)


@pytest.mark.parametrize("seed", [0, 1])
def test_two_level_hash_matches_reference(seed):
    rng = np.random.default_rng(seed)
    rows = random_bits(rng, 200, 3, 0.05)
    rows = np.concatenate([rows, rows[:50], np.zeros((3, 3), np.uint32)])
    ref, port = ref_hashindex.TwoLevelHash(), hashindex.TwoLevelHash()
    for lo in range(0, rows.shape[0], 64):
        chunk = rows[lo: lo + 64]
        assert port.add_batch(chunk) == ref.add_batch(chunk)
    assert len(port) == len(ref)
    assert port.bucket_stats() == ref.bucket_stats()
    for r in rows[:20]:
        assert (r in port) == (r in ref)
        assert port.add(r) == ref.add(r)


@pytest.mark.parametrize("W", [1, 3, 4])
def test_batch_heads_twins_match_reference(W):
    rng = np.random.default_rng(W)
    rows = random_bits(rng, 300, W, 0.02)
    rows[:4] = 0
    rows[4, -1] = 0x80000000  # only bit 31 of the last word
    rows[5, 0] = 0x80000001
    want = np.asarray(ref_hashindex.batch_heads_jnp(jnp.asarray(rows)))
    np.testing.assert_array_equal(hashindex.batch_heads(rows), ref_hashindex.batch_heads(rows))
    np.testing.assert_array_equal(hashindex.batch_heads_torch(t(rows)).numpy(), want)


@pytest.mark.parametrize("n_attrs", [7, 32, 45])
def test_lectic_twins_match_reference(n_attrs):
    rng = np.random.default_rng(n_attrs)
    W = bitset.n_words(n_attrs)
    mask = bitset.attr_mask(n_attrs, W)
    Y = random_bits(rng, 9, W, 0.4) & mask
    gens = rng.integers(-1, n_attrs, size=9).astype(np.int32)
    rt, pt = ref_lectic.LecticTables(n_attrs), lectic.LecticTables(n_attrs)
    for name in ("LOW", "BIT", "attr_mask"):
        assert getattr(pt, name).tobytes() == getattr(rt, name).tobytes()
    LOW, BIT = jnp.asarray(rt.LOW), jnp.asarray(rt.BIT)

    np.testing.assert_array_equal(
        lectic.member_bits_torch(t(Y), n_attrs).numpy(),
        np.asarray(ref_lectic.member_bits_jnp(jnp.asarray(Y), n_attrs)))
    s_ref, v_ref = ref_lectic.oplus_seeds_jnp(jnp.asarray(Y), LOW, BIT, n_attrs)
    s, v = lectic.oplus_seeds_torch(t(Y), t(pt.LOW), t(pt.BIT), n_attrs)
    np.testing.assert_array_equal(u32(s), u32(s_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    s_ref, v_ref = ref_lectic.cbo_seeds_jnp(jnp.asarray(Y), jnp.asarray(gens), BIT, n_attrs)
    s, v = lectic.cbo_seeds_torch(t(Y), torch.from_numpy(gens), t(pt.BIT), n_attrs)
    np.testing.assert_array_equal(u32(s), u32(s_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))

    closures = random_bits(rng, n_attrs, W, 0.5) & mask
    parents = np.repeat(Y[:1], n_attrs, axis=0)
    g = np.arange(n_attrs, dtype=np.int32)
    ok_ref = ref_lectic.feasible_jnp(jnp.asarray(closures), jnp.asarray(parents),
                                     jnp.asarray(g), LOW)
    ok = lectic.feasible_torch(t(closures), t(parents), torch.from_numpy(g), t(pt.LOW))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
    for flags in (np.asarray(ok_ref), np.zeros(n_attrs, bool), rng.random(n_attrs) < 0.3):
        y_ref, f_ref = ref_lectic.select_lectic(jnp.asarray(closures), jnp.asarray(flags))
        y, f = lectic.select_lectic(t(closures), torch.from_numpy(flags))
        np.testing.assert_array_equal(u32(y), u32(y_ref))
        assert bool(f) == bool(f_ref)


def _rows_with_high_bit(seed: int, n: int, W: int) -> tuple[np.ndarray, np.ndarray]:
    """Rows where bit 31 decides the order (the unsigned-order trap), with
    duplicates, and a validity mask."""
    rng = np.random.default_rng(seed)
    rows = random_bits(rng, n, W, 0.5)
    rows[rng.random((n, W)) < 0.5] |= np.uint32(0x80000000)
    rows[: n // 4] = rows[n // 4: n // 2]  # duplicates
    rows[-3:, 0] = [0x80000000, 0x7FFFFFFF, 0xFFFFFFFF]
    valid = rng.random(n) < 0.8
    return rows, valid


@pytest.mark.parametrize("seed,n,W", [(0, 64, 1), (1, 100, 2), (2, 257, 4), (3, 40, 5)])
def test_sort_unique_matches_reference_unsigned_order(seed, n, W):
    rows, valid = _rows_with_high_bit(seed, n, W)
    extra = np.arange(n, dtype=np.int32)
    n_ref, s_ref, e_ref = ref_frontier._sort_unique(
        jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(extra))
    cnt, s, e = frontier._sort_unique(t(rows), torch.from_numpy(valid), torch.from_numpy(extra))
    k = int(n_ref)
    assert int(cnt) == k
    np.testing.assert_array_equal(u32(s)[:k], u32(s_ref)[:k])
    np.testing.assert_array_equal(e.numpy()[:k], np.asarray(e_ref)[:k])


@pytest.mark.parametrize("seed,n,W", [(0, 64, 1), (1, 100, 3), (2, 33, 4)])
def test_compact_matches_reference(seed, n, W):
    rows, valid = _rows_with_high_bit(seed, n, W)
    extra = np.arange(n, dtype=np.int32)
    n_ref, s_ref, e_ref = ref_frontier._compact(
        jnp.asarray(valid), jnp.asarray(rows), jnp.asarray(extra))
    cnt, s, e = frontier._compact(torch.from_numpy(valid), t(rows), torch.from_numpy(extra))
    assert int(cnt) == int(n_ref)
    # stable: the whole permutation matches, not only the survivors
    np.testing.assert_array_equal(u32(s), u32(s_ref))
    np.testing.assert_array_equal(e.numpy(), np.asarray(e_ref))


@pytest.mark.parametrize("dedupe", [False, True])
@pytest.mark.parametrize("n_attrs,F,n_valid", [(24, 16, 11), (40, 8, 8), (33, 4, 1)])
def test_expansions_match_reference(n_attrs, F, n_valid, dedupe):
    rng = np.random.default_rng(n_attrs + F)
    W = bitset.n_words(n_attrs)
    mask = bitset.attr_mask(n_attrs, W)
    Y = random_bits(rng, F, W, 0.3) & mask
    Y[1] = Y[0]
    tables = lectic.LecticTables(n_attrs)
    LOW, BIT = jnp.asarray(tables.LOW), jnp.asarray(tables.BIT)
    s_ref, n_ref = ref_frontier.expand_oplus(
        jnp.asarray(Y), jnp.int32(n_valid), LOW, BIT, n_attrs=n_attrs, dedupe=dedupe)
    s, n = frontier.expand_oplus(t(Y), n_valid, t(tables.LOW), t(tables.BIT),
                                 n_attrs=n_attrs, dedupe=dedupe)
    k = int(n_ref)
    assert int(n) == k
    np.testing.assert_array_equal(u32(s)[:k], u32(s_ref)[:k])

    gens = rng.integers(-1, n_attrs, size=F).astype(np.int32)
    ref_out = ref_frontier.expand_cbo(jnp.asarray(Y), jnp.asarray(gens), jnp.int32(n_valid),
                                      BIT, n_attrs=n_attrs)
    out = frontier.expand_cbo(t(Y), torch.from_numpy(gens), n_valid, t(tables.BIT),
                              n_attrs=n_attrs)
    k = int(ref_out[3])
    assert int(out[3]) == k
    np.testing.assert_array_equal(u32(out[0])[:k], u32(ref_out[0])[:k])
    np.testing.assert_array_equal(u32(out[1])[:k], u32(ref_out[1])[:k])
    np.testing.assert_array_equal(out[2].numpy()[:k], np.asarray(ref_out[2])[:k])


@pytest.mark.parametrize("lo,cap", [(0, 8), (5, 16), (30, 8)])
def test_slice_pad_matches_reference(lo, cap):
    arr = np.arange(32 * 2, dtype=np.uint32).reshape(32, 2) | np.uint32(0x80000000)
    want = np.asarray(ref_frontier.slice_pad(jnp.asarray(arr), lo, cap))
    np.testing.assert_array_equal(u32(frontier.slice_pad(t(arr), lo, cap)), want)


def test_bitset_helpers_match_reference():
    import repro.core.bitset as ref_bitset

    rng = np.random.default_rng(7)
    rows = random_bits(rng, 20, 3, 0.3)
    for n_attrs in (1, 31, 32, 70, 96):
        assert bitset.attr_mask(n_attrs).tobytes() == ref_bitset.attr_mask(n_attrs).tobytes()
    np.testing.assert_array_equal(bitset.popcount(rows), ref_bitset.popcount(rows))
    np.testing.assert_array_equal(bitset.unpack_bits(rows, 90), ref_bitset.unpack_bits(rows, 90))
    dense = rng.random((5, 70)) < 0.5
    np.testing.assert_array_equal(bitset.pack_bool(dense), ref_bitset.pack_bool(dense))
    assert [bitset.head_attr(r) for r in rows] == [ref_bitset.head_attr(r) for r in rows]
