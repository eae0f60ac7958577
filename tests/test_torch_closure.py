"""K1's plain version and the port's ``batched_closure`` against the JAX
package: the Pallas kernel in interpret mode, its jnp oracle
``closure_ref`` and the reference ``ops.batched_closure``.  Closures and
supports are integers and bitsets, so every comparison is exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import closure as ref_core_closure
from repro.kernels import closure as ref_kclosure
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kref
from repro_torch.core import bitset
from repro_torch.core import closure as core_closure
from repro_torch.kernels import closure as kclosure
from repro_torch.kernels import ops, ref

from _torch_reference import edge_rows, pad_ones, random_bits, subset_candidates, t, u32


def _case(N: int, B: int, W: int, density: float, seed: int):
    rng = np.random.default_rng(seed)
    rows = random_bits(rng, N, W, density)
    return rows, subset_candidates(rng, rows, B)


def _assert_same(got, want):
    np.testing.assert_array_equal(u32(got[0]), u32(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]).astype(np.int64),
                                  np.asarray(want[1]).astype(np.int64))


@pytest.mark.parametrize(
    "N,B,W,density",
    [(256, 8, 1, 0.6), (512, 16, 4, 0.7), (256, 24, 5, 0.8), (768, 8, 2, 0.9),
     (256, 8, 10, 0.85)],
)
def test_closure_plain_matches_pallas_interpret(N, B, W, density):
    rows, cands = _case(N, B, W, density, seed=N + B + W)
    want = ref_kclosure.closure_pallas(jnp.asarray(rows), jnp.asarray(cands), interpret=True)
    _assert_same(kclosure.closure_plain(t(rows), t(cands)), want)
    _assert_same(kclosure.closure(t(rows), t(cands)), want)


# K1's tensor-core body at its edges (chip_smoke.py's TC_EDGE_*, at CPU
# sizes): W at 1, 4, 5, 10 (the widest the body takes) and 11 (the SIMT
# body); N and B beside the 64-row stages and the 64-candidate warpgroups;
# k = 1 shard with the engine's all-ones pad rows, k = 2 with candidates
# that match no row; rows with bit 31 set.  The reference kernel takes rows
# padded to its 256-row block with all-ones rows, which change no closure
# and add one match each to every support.
@pytest.mark.parametrize("N,B", [(1, 1), (63, 65), (65, 63)])
@pytest.mark.parametrize("W", [1, 4, 5, 10, 11])
def test_closure_plain_matches_pallas_interpret_at_the_body_edges(W, N, B):
    rng = np.random.default_rng(3000 * W + N + B)
    for k, pad in ((1, True), (2, False)):
        rows, cands = edge_rows(rng, k * N, W, B, pad)
        cands_ref, _ = pad_ones(cands, 8)
        want_c, want_s = [], []
        for i in range(k):
            shard, n_added = pad_ones(rows[i * N:(i + 1) * N], 256)
            c, s_ = ref_kclosure.closure_pallas(jnp.asarray(shard), jnp.asarray(cands_ref),
                                                interpret=True)
            want_c.append(u32(c)[:B])
            want_s.append(np.asarray(s_)[:B] - n_added)
        shards = t(rows) if k == 1 else t(rows).reshape(k, N, W)
        for fn in (kclosure.closure_plain, kclosure.closure):
            gc, gs = fn(shards, t(cands))
            np.testing.assert_array_equal(u32(gc).reshape(k, B, W), np.stack(want_c))
            np.testing.assert_array_equal(gs.numpy().reshape(k, B), np.stack(want_s))
        if not pad and B > 1:  # the candidates that match no row, in every shard
            assert (gs.numpy()[:, 1::3] == 0).all()
            assert (u32(gc)[:, 1::3] == 0xFFFFFFFF).all()


@pytest.mark.parametrize(
    "N,B,W,density",
    [(1, 1, 1, 0.5), (100, 3, 4, 0.7), (300, 17, 3, 0.95), (40, 9, 520, 0.99),
     (64, 5, 600, 0.995)],
)
def test_closure_ref_matches_jnp_oracle(N, B, W, density):
    """Ragged shapes and widths past the reference kernel's MAX_W=512."""
    rows, cands = _case(N, B, W, density, seed=7 * N + W)
    want = ref_kref.closure_ref(jnp.asarray(rows), jnp.asarray(cands))
    _assert_same(ref.closure_ref(t(rows), t(cands)), want)
    _assert_same(kclosure.closure(t(rows), t(cands)), want)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize(
    "N,n_valid,B,n_attrs",
    [(256, 256, 8, 32),      # exact block multiples, no padding at all
     (512, 500, 16, 100),    # pre-existing all-ones rows
     (1000, 1000, 13, 125),  # ragged N and B: the wrapper pads both
     (37, 30, 1, 7),
     (300, 300, 5, 16640)],  # W = 520 > the reference kernel's MAX_W
)
def test_batched_closure_matches_reference(N, n_valid, B, n_attrs, use_kernel):
    W = bitset.n_words(n_attrs)
    rng = np.random.default_rng(N + B)
    rows = random_bits(rng, N, W, 0.8 if W < 100 else 0.995) & bitset.attr_mask(n_attrs, W)
    rows[n_valid:] = 0xFFFFFFFF  # the caller's own all-ones padding
    cands = subset_candidates(rng, rows[:n_valid], B) & bitset.attr_mask(n_attrs, W)
    want = ref_ops.batched_closure(jnp.asarray(rows), jnp.asarray(cands), n_attrs,
                                   n_valid_rows=n_valid, use_kernel=use_kernel)
    got = ops.batched_closure(t(rows), t(cands), n_attrs, n_valid_rows=n_valid,
                              use_kernel=use_kernel)
    _assert_same(got, want)
    # and against the host oracle, on the real rows only
    oc, os_ = ref_core_closure.batched_closure_np(rows[:n_valid], cands,
                                                  bitset.attr_mask(n_attrs, W))
    _assert_same(got, (oc, os_))


@pytest.mark.parametrize("kind", ["empty", "all_ones", "single_attr"])
def test_closure_special_candidates(kind):
    rng = np.random.default_rng(3)
    rows = random_bits(rng, 512, 4, 0.5)
    if kind == "empty":
        cands = np.zeros((8, 4), np.uint32)
    elif kind == "all_ones":
        cands = np.full((8, 4), 0xFFFFFFFF, np.uint32)
    else:
        cands = np.zeros((8, 4), np.uint32)
        for i in range(8):
            cands[i, i % 4] = np.uint32(1) << np.uint32(31 - i)
    want = ref_kclosure.closure_pallas(jnp.asarray(rows), jnp.asarray(cands), interpret=True)
    _assert_same(kclosure.closure(t(rows), t(cands)), want)


def test_pad_correction_at_exact_block_multiple():
    """N already a multiple of block_n: no rows are added and supports are
    corrected only by the caller's own padding."""
    rng = np.random.default_rng(11)
    rows = random_bits(rng, 512, 2, 0.7)
    rows[-6:] = 0xFFFFFFFF
    cands = subset_candidates(rng, rows[:-6], 16)
    want = ref_ops.batched_closure(jnp.asarray(rows), jnp.asarray(cands), 60,
                                   n_valid_rows=506)
    got = ops.batched_closure(t(rows), t(cands), 60, n_valid_rows=506)
    _assert_same(got, want)
    assert int(got[1][0]) == 506  # the empty candidate matches every real row


@pytest.mark.parametrize("N,B,W", [(50, 7, 3), (256, 16, 1)])
def test_core_torch_half_matches_jnp(N, B, W):
    rows, cands = _case(N, B, W, 0.7, seed=N * B)
    n_attrs = W * 32 - 5
    mask = bitset.attr_mask(n_attrs, W)
    want = jax.jit(ref_core_closure.batched_closure_jnp)(
        jnp.asarray(rows), jnp.asarray(cands), jnp.asarray(mask))
    _assert_same(core_closure.batched_closure_torch(t(rows), t(cands), t(mask)), want)
    np.testing.assert_array_equal(
        core_closure.extent_torch(t(rows), t(cands[1])).numpy(),
        np.asarray(ref_core_closure.extent_jnp(jnp.asarray(rows), jnp.asarray(cands[1]))))
    sel = t(rows)
    np.testing.assert_array_equal(
        u32(core_closure._and_reduce(sel, 0)),
        u32(jax.jit(ref_core_closure._and_reduce, static_argnums=1)(jnp.asarray(rows), 0)))


@pytest.mark.parametrize("n", [0, 1, 5, 8, 9, 100, 4096])
def test_bucket_size_matches_reference(n):
    assert ops.bucket_size(n) == ref_ops.bucket_size(n)
    assert ops.bucket_size(n, minimum=16) == ref_ops.bucket_size(n, minimum=16)


def test_plain_version_chunks_large_batches(monkeypatch):
    """The plain version bounds its [b, N, W] intermediate by chunking over
    candidates; chunk boundaries must not change the result."""
    rows, cands = _case(300, 40, 3, 0.7, seed=5)
    whole = kclosure.closure_plain(t(rows), t(cands))
    monkeypatch.setattr(kclosure, "PLAIN_CHUNK_ELEMS", 300 * 3 * 7)
    chunked = kclosure.closure_plain(t(rows), t(cands))
    _assert_same(chunked, whole)
    assert torch.equal(chunked[1], whole[1])
