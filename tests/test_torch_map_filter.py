"""K3 (map) and K4 (filter), the two halves of a multi-shard frontier step,
and the shard-batched K1 and ``closure_matmul``, against the JAX package.

The plain versions are held against the reference's Pallas kernels in
interpret mode (``map_closure_call``, ``filter_call``, ``closure_pallas``
through ``batched_closure``) and against its ``closure_matmul``; the
engine's fused multi-shard steps against the reference engine's steps of
the same name (``backend="jnp"``, with the jax-0.9 binding).  On the CPU
the wrappers run their plain versions.  Tolerance: exact equality of
words, counts and keep masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.core.context as ref_context
from repro.core.frontier import DeviceFrontier as RefFrontier
from repro.dist import collectives as ref_collectives
from repro.dist.shardplan import SIM_AXIS
from repro.kernels import frontier as ref_fkern
from repro.kernels import ops as ref_ops
import repro_torch.core as core
from repro_torch import kernels
from repro_torch.core import bitset
from repro_torch.core.frontier import DeviceFrontier
from repro_torch.dist import collectives
from repro_torch.kernels import closure as kclosure
from repro_torch.kernels import frontier as fkern
from repro_torch.kernels import ops

from _torch_reference import (  # noqa: F401
    edge_rows, jax_reference, pad_ones, port_context, random_bits, subset_candidates, t, u32,
)

N_LOCAL = 256  # rows per shard: the reference kernels' row block

WINDOWS = {
    # (n_valid, min_sup, n_pad, row_off) as functions of B
    "full": lambda B: (B, 1, 0, 0),
    "window": lambda B: (B - B // 3, 40, 5, 0),
    "offset": lambda B: (B // 2 + 1, 3, 1, B // 4),
    "empty": lambda B: (0, 0, 0, 0),
}
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _sharded_case(k: int, n_attrs: int, B: int, seed: int):
    """Rows [k·N_LOCAL, W] with bit 31 set somewhere, subset candidates."""
    rng = np.random.default_rng(seed)
    W = bitset.n_words(n_attrs)
    mask = bitset.attr_mask(n_attrs, W)
    rows = random_bits(rng, k * N_LOCAL, W, 0.8)
    rows[::3, 0] |= np.uint32(1 << 31)
    cands = subset_candidates(rng, rows & mask, B)
    return rows, cands, mask[None, :]


@pytest.mark.parametrize("n_attrs", [45, 64])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_map_closure_plain_matches_pallas_interpret(k, n_attrs):
    B = 16
    rows, cands, mask = _sharded_case(k, n_attrs, B, seed=10 * k + n_attrs)
    W = rows.shape[1]
    want_c, want_s = [], []
    for i in range(k):
        c, s = ref_fkern.map_closure_call(
            jnp.asarray(rows[i * N_LOCAL:(i + 1) * N_LOCAL]), jnp.asarray(cands),
            jnp.asarray(mask), interpret=True)
        want_c.append(np.asarray(c))
        want_s.append(np.asarray(s))
    rows3 = t(rows).reshape(k, N_LOCAL, W)
    for fn in (fkern.map_closure_plain, fkern.map_closure):
        gc, gs = fn(rows3, t(cands), t(mask))
        assert tuple(gc.shape) == (k, B, W) and tuple(gs.shape) == (k, B)
        np.testing.assert_array_equal(u32(gc), np.stack(want_c))
        np.testing.assert_array_equal(gs.numpy(), np.stack(want_s))
    if k == 1:  # a process-group rank's 2-D slice
        gc, gs = fkern.map_closure(t(rows), t(cands), t(mask))
        np.testing.assert_array_equal(u32(gc), want_c[0])
        np.testing.assert_array_equal(gs.numpy(), want_s[0])


# The closure bodies' edges (as in test_torch_fused.py): W at 1, 5, 10 (the
# tensor body's widest) and 11; rows per shard and B beside the tensor
# body's 64-row stages and 64/128-candidate tiles; all-ones pad rows in the
# last shard, or candidates that match no row.  Each shard goes through the
# reference kernel padded with all-ones rows to its 256-row block (their
# matches subtracted from its raw supports), the candidates to 8 rows.
EDGE_W = [1, 5, 10, 11]
EDGE_NB = [(1, 1), (63, 65), (65, 63), (300, 9)]


@pytest.mark.parametrize("n,B", EDGE_NB)
@pytest.mark.parametrize("W", EDGE_W)
def test_map_closure_plain_matches_pallas_interpret_at_the_body_edges(W, n, B):
    rng = np.random.default_rng(2000 * W + n + B)
    mask = bitset.attr_mask(32 * W - 3, W)[None, :]
    for k, pad in ((1, True), (2, False)):
        rows, cands = edge_rows(rng, k * n, W, B, pad)
        cands_ref, _ = pad_ones(cands, 8)
        want_c, want_s = [], []
        for i in range(k):
            shard, n_added = pad_ones(rows[i * n:(i + 1) * n], N_LOCAL)
            c, s_ = ref_fkern.map_closure_call(jnp.asarray(shard), jnp.asarray(cands_ref),
                                               jnp.asarray(mask), interpret=True)
            want_c.append(u32(c)[:B])
            want_s.append(np.asarray(s_)[:B] - n_added)
        shards = t(rows) if k == 1 else t(rows).reshape(k, n, W)
        for fn in (fkern.map_closure_plain, fkern.map_closure):
            gc, gs = fn(shards, t(cands), t(mask))
            np.testing.assert_array_equal(u32(gc).reshape(k, B, W), np.stack(want_c))
            np.testing.assert_array_equal(gs.numpy().reshape(k, B), np.stack(want_s))
        if not pad and B > 1:  # the candidates that match no row, in every shard
            assert (gs.numpy()[:, 1::3] == 0).all()


def test_the_wrappers_count_no_cpu_call_and_reset_clears_both_counters():
    """On the CPU K2 and K3 run their plain versions on both sides of the
    tensor body's widest W and count no launch of either body (on the card
    chip_smoke.py holds the launchers' choice by W to the counters);
    ``reset_launches`` sets ``launches`` and ``tc_launches`` to 0."""
    kernels.reset_launches()
    rng = np.random.default_rng(7)
    for W in (10, 11):
        rows, cands = edge_rows(rng, 70, W, 9, True)
        mask = t(bitset.attr_mask(32 * W, W)[None, :])
        for got, want in (
            (fkern.map_closure(t(rows), t(cands), mask),
             fkern.map_closure_plain(t(rows), t(cands), mask)),
            (fkern.fused_step(t(rows), t(cands), mask, (9, 0, 5, 0)),
             fkern.fused_step_plain(t(rows), t(cands), mask, (9, 0, 5, 0))),
        ):
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    for fn in (fkern.fused_step, fkern.map_closure):
        assert fn.launches == 0 and fn.tc_launches == 0
        fn.launches = fn.tc_launches = 3
    kernels.reset_launches()
    for fn in (fkern.fused_step, fkern.map_closure):
        assert fn.launches == fn.tc_launches == 0


def _ref_round(lc: np.ndarray, ls: np.ndarray, impl: str, n_attrs: int):
    """The reference's simulated round between K3 and K4: the AND-allreduce
    of the shards' partials and the psum of their supports, under
    ``jax.vmap`` over the plan's shard axis (the reference engine's body)."""
    def body(x, s):
        return (ref_collectives.and_allreduce(x, SIM_AXIS, impl=impl, n_attrs=n_attrs),
                jax.lax.psum(s, SIM_AXIS))

    gc, gs = jax.vmap(body, axis_name=SIM_AXIS)(jnp.asarray(lc), jnp.asarray(ls))
    return gc[0], gs[0]


# K4 on K shards' partials: B = 25 is a multiple of no K > 1 here (the
# reference's rsag pads it), and of the reference filter's 5-row blocks.
PARTIAL_B = 25
PARTIAL_W = (1, 4, 5)


@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("iceberg,cbo", FLAGS)
@pytest.mark.parametrize("K", [1, 2, 3, 8])
def test_filter_step_plain_matches_pallas_interpret(jax_reference, K, iceberg, cbo,  # noqa: F811
                                                    window):
    """K4's plain version (and its wrapper, on the CPU) on K shards'
    partials against the reference's simulated AND-allreduce + psum, then
    ``filter_call`` in interpret mode on the reduced operands with
    ``lowrow = LOW[gens]``: closures, supports and keep bit for bit, at W
    1, 4 and 5 under the three schedules in turn."""
    B = PARTIAL_B
    for W in PARTIAL_W:
        rng = np.random.default_rng(1000 * K + 100 * W + 10 * len(window) + 2 * iceberg + cbo)
        n_attrs = 32 * W - 3
        mask = bitset.attr_mask(n_attrs, W)
        lc = random_bits(rng, K * B, W, 0.93).reshape(K, B, W) & mask
        ls = rng.integers(0, 100 // K + 2, size=(K, B)).astype(np.int32)
        parent = np.bitwise_and.reduce(lc, 0) & random_bits(rng, B, W, 0.7)
        LOW = random_bits(rng, n_attrs, W, 0.05) & mask
        gens = rng.integers(0, n_attrs, size=B).astype(np.int32)
        scalars = WINDOWS[window](B)
        impl = collectives.IMPLS[(K + W) % 3]
        gc_ref, gs_ref = _ref_round(lc, ls, impl, n_attrs)
        ref_kw = dict(iceberg=iceberg, cbo=cbo, block_b=5, interpret=True)
        kw = dict(iceberg=iceberg, cbo=cbo)
        if cbo:
            ref_kw.update(parent=jnp.asarray(parent), lowrow=jnp.asarray(LOW[gens]))
            kw.update(parent=t(parent), LOW=t(LOW), gens=torch.from_numpy(gens))
        want_s, want_k = ref_fkern.filter_call(gc_ref, gs_ref,
                                               ref_fkern.pack_scalars(*scalars), **ref_kw)
        operands = [(t(lc.reshape(K * B, W)).reshape(K, B, W), torch.from_numpy(ls))]
        if K == 1:  # a process-group rank's reduced [B, W] / [B]
            operands.append((t(lc[0]), torch.from_numpy(ls[0])))
        for lc_t, ls_t in operands:
            for fn in (fkern.filter_step_plain, fkern.filter_step):
                gc, sup, keep = fn(lc_t, ls_t, fkern.pack_scalars(*scalars), **kw)
                np.testing.assert_array_equal(u32(gc), u32(gc_ref))
                np.testing.assert_array_equal(sup.numpy(), np.asarray(want_s))
                np.testing.assert_array_equal(keep.numpy(), np.asarray(want_k))
                assert keep.dtype == torch.bool and sup.dtype == torch.int32
                if not iceberg:  # no supports asked: the same closures and keep
                    gc2, sup2, keep2 = fn(lc_t, None, fkern.pack_scalars(*scalars), **kw)
                    assert sup2 is None and torch.equal(gc2, gc) and torch.equal(keep2, keep)


def test_filter_step_drops_a_generator_outside_low():
    """A gens entry outside [0, n_low) drops its candidate (the frontier
    never sends one); the other candidates keep the CbO test's answer."""
    B, W = 6, 2
    lc = torch.zeros((2, B, W), dtype=torch.int32)
    LOW = torch.zeros((3, W), dtype=torch.int32)
    gens = torch.tensor([0, 1, 2, 3, -1, 2], dtype=torch.int32)
    for fn in (fkern.filter_step_plain, fkern.filter_step):
        _, _, keep = fn(lc, None, (B, 0, 0, 0), parent=lc[0], LOW=LOW, gens=gens, cbo=True)
        assert keep.tolist() == [True, True, True, False, False, True]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_k1_over_shards_matches_reference_per_shard(k):
    B, n_attrs = 13, 64
    rows, cands, mask = _sharded_case(k, n_attrs, B, seed=k)
    W = rows.shape[1]
    rows3 = t(rows).reshape(k, N_LOCAL, W)
    got_c, got_s = ops.batched_closure(rows3, t(cands), n_attrs, n_valid_rows=N_LOCAL - 3)
    raw_c, raw_s = kclosure.closure(rows3, t(cands))
    assert tuple(got_c.shape) == (k, B, W)
    for i in range(k):
        want_c, want_s = ref_ops.batched_closure(
            jnp.asarray(rows[i * N_LOCAL:(i + 1) * N_LOCAL]), jnp.asarray(cands), n_attrs,
            n_valid_rows=N_LOCAL - 3, interpret=True)
        np.testing.assert_array_equal(u32(got_c[i]), np.asarray(want_c))
        np.testing.assert_array_equal(got_s[i].numpy(), np.asarray(want_s))
        one_c, one_s = kclosure.closure(rows3[i].contiguous(), t(cands))
        assert torch.equal(raw_c[i], one_c) and torch.equal(raw_s[i], one_s)


@pytest.mark.parametrize("n_attrs", [24, 64, 133])
def test_closure_matmul_matches_reference(n_attrs):
    rng = np.random.default_rng(n_attrs)
    W = bitset.n_words(n_attrs)
    mask = bitset.attr_mask(n_attrs, W)
    rows = random_bits(rng, 2 * 96, W, 0.85) & mask
    rows[-5:] = 0xFFFFFFFF  # all-ones padding rows
    cands = subset_candidates(rng, rows, 12) & mask
    shards = t(rows).reshape(2, 96, W)
    got_c, got_s = ops.closure_matmul(shards, t(cands), n_attrs, n_valid_rows=96)
    for i in range(2):
        want_c, want_s = ref_ops.closure_matmul(
            jnp.asarray(rows[i * 96:(i + 1) * 96]), jnp.asarray(cands), n_attrs,
            n_valid_rows=96)
        np.testing.assert_array_equal(u32(got_c[i]), np.asarray(want_c))
        np.testing.assert_array_equal(got_s[i].numpy(), np.asarray(want_s))
    whole_c, whole_s = ops.closure_matmul(t(rows), t(cands), n_attrs, n_valid_rows=187)
    want_c, want_s = ref_ops.closure_matmul(jnp.asarray(rows), jnp.asarray(cands), n_attrs,
                                            n_valid_rows=187)
    np.testing.assert_array_equal(u32(whole_c), np.asarray(want_c))
    np.testing.assert_array_equal(whole_s.numpy(), np.asarray(want_s))


def _step_args(variant: str, ctx_rows: np.ndarray, W: int, n_attrs: int, B: int):
    rng = np.random.default_rng(len(variant))
    cands = subset_candidates(rng, ctx_rows, B)
    parents = cands & random_bits(rng, B, W, 0.5) & bitset.attr_mask(n_attrs, W)
    gens = rng.integers(0, n_attrs, size=B).astype(np.int32)
    n_valid, min_sup = B - 3, 6
    iceberg, cbo, _ = fkern.VARIANTS[variant]
    args = [cands]
    if cbo:
        args += [parents, gens]
    if variant != "plain":
        args.append(n_valid)
    if iceberg:
        args.append(min_sup)
    return args


@pytest.mark.parametrize("impl", ["rsag", "auto", "allgather", "pmin"])
@pytest.mark.parametrize("k", [2, 4, 3, 8])
@pytest.mark.parametrize("variant", sorted(fkern.VARIANTS))
def test_fused_multi_shard_step_matches_reference(jax_reference, variant, k,  # noqa: F811
                                                  impl):
    """The simulated plan's K3 → K4 step (K4 folding the shards' partials)
    against the reference engine's step of the same name, which runs the
    schedule's AND-allreduce between its kernels; and the round's census
    (modeled wire and hop bytes, the schedule's round) equal."""
    ref_ctx = ref_context.FormalContext.synthetic(60, 24, 0.35, seed=42)
    ref_eng = ref_core.ClosureEngine(ref_ctx, n_parts=k, reduce_impl=impl, backend="jnp")
    eng = core.ClosureEngine(port_context(ref_ctx), n_parts=k, reduce_impl=impl,
                             backend="kernel", device="cpu")
    B = 16
    args = _step_args(variant, ref_ctx.rows, ref_ctx.W, ref_ctx.n_attrs, B)
    want = RefFrontier(ref_eng)._step_fn(variant)(
        ref_eng.rows, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    port_args = [
        a if not isinstance(a, np.ndarray) else t(a) if a.dtype == np.uint32
        else torch.from_numpy(a) for a in args
    ]
    got = DeviceFrontier(eng)._step_fn(variant)(eng.rows, *port_args)
    ref_eng.charge_round(B, B - 3)
    eng.charge_round(B, B - 3)
    for key in ("modeled_comm_bytes", "modeled_dispatch_bytes", "modeled_collective_bytes",
                "reduce_rounds"):
        assert getattr(eng.stats, key) == getattr(ref_eng.stats, key), key
    if variant == "plain":
        np.testing.assert_array_equal(u32(got), np.asarray(want).astype(np.uint32))
        return
    n = int(want[-1])
    assert int(got[-1]) == n
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(u32(g[:n]), np.asarray(w)[:n].astype(np.uint32))


@pytest.mark.parametrize("driver", ["mrganter+", "mrcbo"])
def test_kernel_backend_routes_multi_shard_steps_through_k3_and_k4(monkeypatch, driver):
    calls = {"fused_step": 0, "map_closure": 0, "filter_step": 0}
    for name in calls:
        real = getattr(fkern, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fkern, name, counted)
    ctx = core.paper_context()
    eng = core.ClosureEngine(ctx, n_parts=2, backend="kernel", device="cpu")
    if driver == "mrganter+":
        res = core.mrganter_plus(ctx, eng, local_prune=True, min_support=2)
    else:
        res = core.mrcbo(ctx, eng, min_support=2)
    assert res.n_concepts > 1
    assert calls["fused_step"] == 0  # K2 belongs to one-shard plans only
    assert calls["map_closure"] > 0 and calls["filter_step"] > 0


def test_multi_shard_runs_launch_no_kernel_on_the_cpu():
    kernels.reset_launches()
    ctx = core.paper_context()
    core.mrcbo(ctx, core.ClosureEngine(ctx, n_parts=4, backend="kernel", device="cpu"))
    assert [k.launches for k in kernels.KERNELS] == [0] * len(kernels.KERNELS)
    assert {k.__name__ for k in kernels.KERNELS} == {
        "closure", "fused_step", "map_closure", "filter_step", "contains_topk", "rules_topk",
        "flash_attention", "blockwise_attention", "attention_backward"}


def _bits(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize(
    "rows,cands,mask,error",
    [
        (_bits(2, 2, 256, 4), _bits(8, 4), _bits(1, 4), ValueError),
        (_bits(2, 256, 4), _bits(8, 5), _bits(1, 4), ValueError),
        (_bits(2, 256, 4), _bits(8, 4), _bits(4), ValueError),
        (_bits(2, 256, 4), _bits(8, 4), _bits(1, 4, dtype=torch.int64), TypeError),
        (_bits(2, 256, 4, dtype=torch.int64), _bits(8, 4), _bits(1, 4), TypeError),
        (_bits(256, 2, 4).transpose(0, 1), _bits(8, 4), _bits(1, 4), ValueError),
    ],
    ids=["4-D", "W-mismatch", "mask-1-D", "mask-dtype", "rows-int64", "non-contiguous"],
)
def test_map_closure_refuses_bad_operands(rows, cands, mask, error):
    with pytest.raises(error):
        fkern.map_closure(rows, cands, mask)


_CBO = {"cbo": True, "parent": _bits(8, 4), "LOW": _bits(5, 4),
        "gens": _bits(8)}


@pytest.mark.parametrize(
    "kwargs,error",
    [
        ({"gs": _bits(2, 7)}, ValueError),
        ({"gs": _bits(2, 8, dtype=torch.int64)}, TypeError),
        ({"gc": _bits(8)}, ValueError),
        ({"cbo": True}, ValueError),
        ({**_CBO, "LOW": _bits(5, 3)}, ValueError),
        ({"scalars": (1, 2, 3)}, ValueError),
        ({"scalars": (2**31, 0, 0, 0)}, ValueError),
        ({"gc": _bits(1, 2, 8, 4)}, ValueError),
        ({**_CBO, "gens": _bits(8, dtype=torch.int64)}, TypeError),
        ({**_CBO, "gens": _bits(7)}, ValueError),
        ({**_CBO, "LOW": _bits(0, 4)}, ValueError),
        ({"gs": None, "iceberg": True}, ValueError),
    ],
    ids=["gs-shape", "gs-dtype", "gc-1-D", "cbo-no-operands", "lowrow-shape",
         "scalar-count", "scalar-range", "lc-4-D", "gens-dtype", "gens-shape", "LOW-empty",
         "iceberg-no-supports"],
)
def test_filter_step_refuses_bad_operands(kwargs, error):
    """lc [K, B, W] / ls [K, B] (here K = 2), or [B, W] / [B]."""
    args = {"gc": _bits(2, 8, 4), "gs": _bits(2, 8), "scalars": (8, 0, 0, 0)}
    args.update(kwargs)
    with pytest.raises(error):
        fkern.filter_step(args.pop("gc"), args.pop("gs"), args.pop("scalars"), **args)
