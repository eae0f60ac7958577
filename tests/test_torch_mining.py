"""The port's MR* drivers against the JAX package's, end to end.

Each case runs one driver of ``repro`` (``backend="jnp"``) and the same
driver of ``repro_torch`` (``backend="torch"`` and ``backend="kernel"``,
both on the CPU, where the kernel wrappers run their plain versions) on
the very same context rows, and requires equal intents in equal order,
equal iteration and closure counts, an equal modeled byte census, and
equal ``EngineStats`` integer fields.  The reference side needs the
jax-0.9 binding of the ``jax_reference`` fixture.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as ref_core
import repro.core.context as ref_context
import repro.data.fca_datasets as ref_datasets
import repro_torch.core as core
from repro_torch.core.engine import EngineStats

from _torch_reference import jax_reference, port_context, random_bits, t, u32  # noqa: F401

CONTEXTS = {
    "paper": ref_context.paper_context,
    "synthetic": lambda: ref_context.FormalContext.synthetic(60, 24, 0.35, seed=42),
    "mushroom-0.01": lambda: ref_datasets.load("mushroom", scale=0.01)[0],
}
DRIVERS = {
    "mrganter": ("mrganter", {}),
    "mrganter+": ("mrganter_plus", {"dedupe_candidates": True}),
    "mrganter+plain": ("mrganter_plus", {}),
    # device dedupe of closure outputs: the unique / iceberg_unique variants
    "mrganter+dedupe": ("mrganter_plus", {"dedupe_candidates": True, "dedupe_closures": True}),
    "mrcbo": ("mrcbo", {}),
}
# iceberg thresholds: ~1/3 of the paper's objects, 10 % of the synthetic
MIN_SUPPORT = {"paper": 2, "synthetic": 6, "mushroom-0.01": None}
STAT_FIELDS = [
    f.name for f in __import__("dataclasses").fields(EngineStats)
    if f.type in ("int", "dict")
]

_reference_runs: dict = {}
_reference_engines: dict = {}


def _cases():
    out = []
    for ctx_name in ("paper", "synthetic"):
        for driver in ("mrganter", "mrganter+", "mrcbo"):
            for pipeline in ("device", "host"):
                for iceberg in (False, True):
                    out.append((ctx_name, driver, pipeline, iceberg))
    out.append(("paper", "mrganter+plain", "device", False))
    out.append(("synthetic", "mrganter+plain", "device", True))
    out.append(("paper", "mrganter+dedupe", "device", False))
    out.append(("synthetic", "mrganter+dedupe", "device", False))
    out.append(("synthetic", "mrganter+dedupe", "device", True))
    out.append(("mushroom-0.01", "mrganter+", "device", False))
    out.append(("mushroom-0.01", "mrcbo", "device", False))
    return out


def _run(pkg_core, ctx, engine, driver, pipeline, min_support):
    fn_name, kw = DRIVERS[driver]
    return getattr(pkg_core, fn_name)(
        ctx, engine, pipeline=pipeline, min_support=min_support, **kw
    )


def _reference(ctx_name, driver, pipeline, min_support):
    """One reference run, on a warm per-context engine whose ledger is
    reset first (the engine's jitted steps are reused across runs)."""
    key = (ctx_name, driver, pipeline, min_support)
    if key not in _reference_runs:
        if ctx_name not in _reference_engines:
            ctx = CONTEXTS[ctx_name]()
            _reference_engines[ctx_name] = (ctx, ref_core.ClosureEngine(ctx, backend="jnp"))
        ctx, eng = _reference_engines[ctx_name]
        eng.stats = type(eng.stats)(auto_hop_bytes=eng.plan.auto_hop_bytes,
                                    hop_calibrated=eng.plan.hop_calibrated)
        res = _run(ref_core, ctx, eng, driver, pipeline, min_support)
        _reference_runs[key] = (ctx, res, {k: getattr(eng.stats, k) for k in STAT_FIELDS})
    return _reference_runs[key]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("ctx_name,driver,pipeline,iceberg", _cases())
def test_driver_matches_reference(jax_reference, ctx_name, driver, pipeline, iceberg,  # noqa: F811
                                  backend):
    min_support = MIN_SUPPORT[ctx_name] if iceberg else None
    ref_ctx, ref_res, ref_stats = _reference(ctx_name, driver, pipeline, min_support)
    ctx = port_context(ref_ctx)
    eng = core.ClosureEngine(ctx, backend=backend, device="cpu")
    res = _run(core, ctx, eng, driver, pipeline, min_support)

    assert [y.tobytes() for y in res.intents] == [
        np.asarray(y, np.uint32).tobytes() for y in ref_res.intents
    ]
    assert res.n_iterations == ref_res.n_iterations
    assert res.n_closures_computed == ref_res.n_closures_computed
    assert res.modeled_comm_bytes == ref_res.modeled_comm_bytes == 0
    assert res.min_support == ref_res.min_support
    assert res.algorithm == ref_res.algorithm
    assert {k: getattr(eng.stats, k) for k in STAT_FIELDS} == ref_stats


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_closure_dev_matches_reference(jax_reference, backend):  # noqa: F811
    ref_ctx = CONTEXTS["synthetic"]()
    rng = np.random.default_rng(1)
    cands = ref_ctx.rows[rng.integers(0, ref_ctx.n_objects, 16)] & random_bits(rng, 16, 1, 0.3)
    ref_eng = ref_core.ClosureEngine(ref_ctx, backend="jnp")
    want = ref_eng.closure_dev(jnp.asarray(cands), 13)
    eng = core.ClosureEngine(port_context(ref_ctx), backend=backend, device="cpu")
    got = eng.closure_dev(t(cands), 13)
    np.testing.assert_array_equal(u32(got[0]), u32(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert {k: getattr(eng.stats, k) for k in STAT_FIELDS} == {
        k: getattr(ref_eng.stats, k) for k in STAT_FIELDS}


def test_stat_fields_cover_the_ledger():
    assert {"rounds", "closure_calls", "closures_computed", "modeled_comm_bytes",
            "h2d_transfers", "h2d_bytes", "d2h_transfers", "d2h_bytes",
            "reduce_rounds"} <= set(STAT_FIELDS)


@pytest.mark.parametrize("driver", ["mrganter", "mrganter+", "mrcbo"])
def test_full_lattice_matches_oracles(driver):
    """The port's drivers on the paper's example against its own copies of
    the centralized NextClosure and CloseByOne oracles."""
    ctx = core.paper_context()
    eng = core.ClosureEngine(ctx, backend="kernel", device="cpu")
    res = _run(core, ctx, eng, driver, "device", None)
    want = {y.tobytes() for y in core.all_closures(ctx)}
    assert {y.tobytes() for y in res.intents} == want
    assert {y.tobytes() for y in core.close_by_one(ctx).intents} == want
    assert res.n_concepts == 21
