"""The port's iceberg entry points against the JAX package's:
threshold resolution and ``mine_iceberg`` end to end."""

from __future__ import annotations

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.context as ref_context
import repro.rules.mining as ref_mining
import repro_torch.core as core
from repro_torch.rules import mining

from _torch_reference import jax_reference, port_context  # noqa: F401


@pytest.mark.parametrize(
    "value,n_objects",
    [(0.07, 100), (0.05, 8124), (406, 8124), (1, 6), (0.5, 6), (0.3333, 3),
     (1e-9, 10), (0.999999, 7), (12.0, 60), (0.1, 60)],
)
def test_resolve_min_support_matches_reference(value, n_objects):
    assert mining.resolve_min_support(value, n_objects) == ref_mining.resolve_min_support(
        value, n_objects)


@pytest.mark.parametrize("value", [0, -1, 1.5, float("nan"), float("inf")])
def test_resolve_min_support_rejects_like_reference(value):
    with pytest.raises(ValueError):
        ref_mining.resolve_min_support(value, 10)
    with pytest.raises(ValueError):
        mining.resolve_min_support(value, 10)


@pytest.fixture(scope="module")
def reference_engine(jax_reference):  # noqa: F811
    """One warm reference engine for the module; each test resets its ledger."""
    ctx = ref_context.FormalContext.synthetic(40, 16, 0.35, seed=9)
    return ctx, ref_core.ClosureEngine(ctx, backend="jnp")


@pytest.mark.parametrize("algorithm", sorted(mining.ALGORITHMS))
@pytest.mark.parametrize("min_support", [0.25, 3])
def test_mine_iceberg_matches_reference(reference_engine, algorithm, min_support):
    ref_ctx, ref_eng = reference_engine
    ref_eng.stats = type(ref_eng.stats)()
    ref_res = ref_mining.mine_iceberg(
        ref_ctx, ref_eng, min_support=min_support, algorithm=algorithm)
    ctx = port_context(ref_ctx)
    res = mining.mine_iceberg(
        ctx, core.ClosureEngine(ctx, backend="kernel", device="cpu"),
        min_support=min_support, algorithm=algorithm)
    assert [y.tobytes() for y in res.intents] == [
        np.asarray(y, np.uint32).tobytes() for y in ref_res.intents]
    assert (res.n_iterations, res.n_closures_computed, res.min_support) == (
        ref_res.n_iterations, ref_res.n_closures_computed, ref_res.min_support)


def test_mine_iceberg_rejects_unknown_algorithm():
    ctx = core.paper_context()
    with pytest.raises(ValueError):
        mining.mine_iceberg(ctx, core.ClosureEngine(ctx, device="cpu"),
                            min_support=2, algorithm="apriori")
