"""Parity harness for the tests/test_torch_*.py files: the JAX package's
reference runs, fed the same numpy inputs as the port.

On jax >= 0.9, ``repro.dist.collectives._axis_size`` calls
``jax.core.axis_frame``, which no longer exists, so every ``ClosureEngine``
round of the reference raises.  The module-scoped ``jax_reference``
fixture binds it with ``monkeypatch.setattr`` while one parity module's
tests run, then removes it and clears jax's caches, so nothing traced
under the binding outlives the module.  It is never installed at import
time or in a conftest: the JAX package's own tests, which can run in the
same worker, must keep failing where the installed jax breaks them.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro_torch.device import device_bits, host_bits
from repro_torch.interop import context_from_arrays

CPU = torch.device("cpu")

# One intra-op thread in the port's test processes: the suite runs six
# pytest workers on eight cores, where torch's default of a thread per core
# spends the shared cores in spin-waits (tests/test_torch_rule_bases.py
# alone in one process: 478 s of CPU for 164 s of wall at eight threads,
# 335 s for 250 s at one; under six workers the CPU time is what counts).
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(
            jax.core, "axis_frame", lambda name: jax.lax.axis_size(name), raising=False
        )
        yield
    jax.clear_caches()


def port_context(ref_ctx):
    """The port's FormalContext over the very rows of a reference context."""
    return context_from_arrays(ref_ctx.rows, ref_ctx.n_objects, ref_ctx.n_attrs)


def t(arr: np.ndarray) -> torch.Tensor:
    """uint32 words → the port's int32 view on the CPU."""
    return device_bits(arr, CPU)


def u32(x) -> np.ndarray:
    """A port int32 tensor or a reference array → uint32 numpy."""
    if isinstance(x, torch.Tensor):
        return host_bits(x)
    return np.asarray(x).astype(np.uint32)


def random_bits(rng, n: int, W: int, density: float) -> np.ndarray:
    """Seeded random packed rows [n, W] (uint32, bit 31 included)."""
    dense = rng.random((n, W * 32)) < density
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (dense.reshape(n, W, 32).astype(np.uint32) * weights).sum(
        -1, dtype=np.uint32
    )


def subset_candidates(rng, rows: np.ndarray, B: int, keep: float = 0.2) -> np.ndarray:
    """Subsets of random rows (non-trivial supports), with the empty and the
    all-ones candidate at the two ends."""
    W = rows.shape[1]
    cands = rows[rng.integers(0, rows.shape[0], size=B)] & random_bits(rng, B, W, keep)
    cands[0] = 0
    if B > 1:
        cands[-1] = 0xFFFFFFFF
    return cands


def edge_rows(rng, n_rows: int, W: int, B: int, pad: bool):
    """Rows and candidates at the closure bodies' edges: bit 31 set in every
    word of every third row; with ``pad`` the last rows all-ones (the
    engine's padding), else bit 30 of word 0 cleared in every row and set in
    every third candidate from the second on, so that those (and the
    all-ones candidate) match no row."""
    rows = random_bits(rng, n_rows, W, 0.8)
    rows[::3] |= np.uint32(1 << 31)
    if pad:
        rows[-min(5, n_rows):] = 0xFFFFFFFF
    else:
        rows[:, 0] &= ~np.uint32(1 << 30)
    cands = subset_candidates(rng, rows, B)
    if not pad:
        cands[1::3, 0] |= np.uint32(1 << 30)
    return rows, cands


def pad_ones(x: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Pad the rows of ``x`` with all-ones rows to a multiple of
    ``multiple`` (the reference kernels' block shapes); returns the padded
    array and the number of rows added."""
    pad = -x.shape[0] % multiple
    fill = np.full((pad, x.shape[1]), 0xFFFFFFFF, dtype=np.uint32)
    return np.concatenate([x, fill]), pad


def repair_livelock(queue):
    """The reference's ``AdmissionQueue`` with ``run_load``'s virtual-clock
    livelock repaired as the port repairs it (ROADMAP C3).  The reference's
    ``run_load`` sleeps only when ``min(next arrival, next_deadline_in)`` is
    positive, and ``next_deadline_in`` can return 0 or less for a deadline
    that ``poll`` does not find due (the two round differently), so an
    injected clock never advances.  The port sleeps its floor there
    (``min(max(wait, 1e-5), 0.002)`` = 1e-5); here ``next_deadline_in``
    returns the smallest positive float instead of 0 or less, which makes
    the reference sleep the very same 1e-5.  Nothing else changes: on a
    virtual clock the reference reaches that branch only when it would
    livelock."""
    next_deadline_in = queue.next_deadline_in

    def repaired(now=None):
        wait = next_deadline_in(now)
        return wait if wait > 0 else 5e-324

    queue.next_deadline_in = repaired
    return queue


def smoke_constants() -> dict:
    """The reference values of chip_smoke.py's serve and rules phases.

    Drives the JAX package (``backend="jnp"``, under the binding above)
    through chip_smoke's own ``serve_answers`` / ``rules_answers`` /
    ``digest``, on the contexts, thresholds, plans and seeded batches those
    phases use.  Several minutes on a CPU; run it as
    ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py``
    and copy the printed JSON into chip_smoke.py.
    """
    import sys
    from pathlib import Path

    import repro.core as ref_core
    from repro.core import bitset
    from repro.data import fca_datasets
    from repro.dist.shardplan import ShardPlan
    from repro.query import ConceptStore, QueryEngine, StreamUpdater
    from repro.query.engine import QueryConfig
    from repro.rules import RuleIndex, extract_bases
    from repro.rules.index import rule_query_mix
    from repro_torch.launch.fca import serve_queries

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "axis_frame", lambda name: jax.lax.axis_size(name),
                   raising=False)
        ctx, _ = fca_datasets.load("mushroom", scale=1.0)
        intents = ref_core.mrcbo(ctx, ref_core.ClosureEngine(ctx, backend="jnp"),
                                 min_support=cs.MAIN_MIN_SUPPORT).intents
        queries = serve_queries(ctx, cs.SERVE_QUERIES, np.random.default_rng(0))
        out["serve"] = {}
        for k in (1, 8):
            store = ConceptStore.build(ctx, intents,
                                       plan=ShardPlan.simulated(k, reduce_impl="rsag"))
            qe = QueryEngine(store, QueryConfig(slots=cs.SERVE_SLOTS, backend="jnp"))
            out["serve"][k] = cs.serve_record(qe, cs.serve_answers(qe, queries))

        sctx, spec = fca_datasets.load("mushroom", scale=0.01)
        sintents = ref_core.mrcbo(sctx, ref_core.ClosureEngine(sctx, backend="jnp")).intents
        out["stream"] = {}
        for k in (1, 8):
            store = ConceptStore.build(sctx, sintents, plan=ShardPlan.simulated(k))
            qe = QueryEngine(store, QueryConfig(slots=cs.SERVE_SLOTS, backend="jnp"))
            rng = np.random.default_rng(0)
            closed = qe.closure_batch(serve_queries(sctx, 256, rng))[0]
            rows = bitset.pack_bool(
                rng.random((cs.STREAM_ROWS, sctx.n_attrs)) < max(0.05, spec.density), sctx.W)
            receipt = StreamUpdater(store).apply(rows)
            post = qe.lookup_batch(closed)
            out["stream"][k] = {
                "n_concepts_before": receipt.n_concepts_before,
                "n_concepts_after": receipt.n_concepts_after,
                "version": store.snapshot.version,
                "post_update_hit_rate": float((post >= 0).mean()),
                "intents_sha256": cs.digest(store.snapshot.intents_np)}

        plan = ShardPlan.simulated(8, reduce_impl="rsag")
        res = ref_core.mrganter_plus(ctx, ref_core.ClosureEngine(ctx, plan=plan, backend="jnp"),
                                     local_prune=True, min_support=cs.RULES_MIN_SUPPORT)
        store = ConceptStore.build(ctx, res.intents, plan=plan)
        basis = extract_bases(store, min_conf=cs.RULES_MIN_CONF)
        index = RuleIndex.build(basis, plan=plan)
        rqueries = rule_query_mix(ctx, index, cs.RULES_QUERIES, np.random.default_rng(0))
        qe = QueryEngine(store, QueryConfig(slots=cs.SERVE_SLOTS, backend="jnp"))
        out["rules"] = {
            "concepts": res.n_concepts, "implications": basis.n_implications,
            "partial": basis.n_partial, "basis_sha256": cs.basis_digest(basis),
            "answers_sha256": {rank: cs.digest(*cs.rules_answers(qe, index, rqueries, rank))
                               for rank in ("confidence", "lift")}}
    jax.clear_caches()
    return out


def cand_constants() -> dict:
    """The reference values of chip_smoke.py's 2-D mining phase.

    For every plan of ``CAND_PLANS`` and driver of ``CAND_DRIVERS`` (and the
    ``CAND_SMALL_BATCH`` run), the JAX package (``backend="jnp"``, under the
    binding above) mines full-scale mushroom at ``MAIN_MIN_SUPPORT`` on
    ``ShardPlan.simulated(k, cand_parts=c, ...)``; census-income as
    published at ``CAND_CENSUS_PLAN`` and ``CENSUS_MIN_SUPPORT``.  Records
    the counts, the modeled wire bytes and the schedule census.  Some
    minutes on a CPU; run it as
    ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py cand``
    and copy the printed JSON into chip_smoke.py's ``CAND_EXPECTED``.
    """
    import sys
    from pathlib import Path

    import repro.core as ref_core
    from repro.data import fca_datasets
    from repro.dist.shardplan import ShardPlan

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    def run(ctx, k, c, impl, driver, min_support, **plan_kw):
        plan = ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl, **plan_kw)
        eng = ref_core.ClosureEngine(ctx, plan=plan, backend="jnp")
        if driver == "mrcbo":
            res = ref_core.mrcbo(ctx, eng, min_support=min_support)
        else:
            res = ref_core.mrganter_plus(ctx, eng, local_prune=True, min_support=min_support,
                                         dedupe_closures=driver == "mrganter+dedupe")
        return {"concepts": res.n_concepts, "iterations": res.n_iterations,
                "closures": res.n_closures_computed, "bytes": res.modeled_comm_bytes,
                "reduce_rounds": dict(eng.stats.reduce_rounds)}

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "axis_frame", lambda name: jax.lax.axis_size(name),
                   raising=False)
        ctx, _ = fca_datasets.load("mushroom", scale=1.0)
        for k, c, impl in cs.CAND_PLANS:
            for driver in cs.CAND_DRIVERS:
                out[cs.cand_key(k, c, impl, driver)] = run(ctx, k, c, impl, driver,
                                                           cs.MAIN_MIN_SUPPORT)
        k, c, impl, mb = cs.CAND_SMALL_BATCH
        out[cs.cand_key(k, c, impl, "mrganter+", mb)] = run(
            ctx, k, c, impl, "mrganter+", cs.MAIN_MIN_SUPPORT, max_batch=mb)
        cctx, _ = fca_datasets.load("census-income", scale=1.0)
        k, c, impl = cs.CAND_CENSUS_PLAN
        out["census " + cs.cand_key(k, c, impl, "mrganter+")] = run(
            cctx, k, c, impl, "mrganter+", cs.CENSUS_MIN_SUPPORT)
    jax.clear_caches()
    return out


def async_constants() -> dict:
    """The reference values of chip_smoke.py's async phase (14).

    For every plan of ``ASYNC_PLANS`` and driver of ``ASYNC_DRIVERS``, the
    ``ASYNC_SMALL_BATCH`` MRGanter+ run and the ``ASYNC_GANTER`` walk, the
    JAX package (``backend="jnp"``, under the binding above) mines
    full-scale mushroom at ``MAIN_MIN_SUPPORT`` with ``rounds="async"`` on
    ``ShardPlan.simulated(k, cand_parts=c, ...)``; census-income as
    published at ``ASYNC_CENSUS_PLAN`` and ``CENSUS_MIN_SUPPORT``.  Records
    chip_smoke's ``async_record``: counts, modeled bytes, schedule,
    transfer and speculation census.  Some minutes on a CPU; run it as
    ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py async``
    and copy the printed JSON into chip_smoke.py's ``ASYNC_EXPECTED``.
    """
    import sys
    from pathlib import Path

    import repro.core as ref_core
    from repro.data import fca_datasets
    from repro.dist.shardplan import ShardPlan

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    def run(ctx, k, c, impl, driver, min_support, max_iterations=None, **plan_kw):
        plan = ShardPlan.simulated(k, cand_parts=c, reduce_impl=impl, **plan_kw)
        eng = ref_core.ClosureEngine(ctx, plan=plan, backend="jnp")
        kw = {"rounds": "async", "min_support": min_support,
              "max_iterations": max_iterations}
        if driver == "mrcbo":
            res = ref_core.mrcbo(ctx, eng, **kw)
        elif driver == "mrganter":
            res = ref_core.mrganter(ctx, eng, **kw)
        else:
            res = ref_core.mrganter_plus(ctx, eng, local_prune=True, **kw)
        return cs.async_record(res, eng)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "axis_frame", lambda name: jax.lax.axis_size(name),
                   raising=False)
        ctx, _ = fca_datasets.load("mushroom", scale=1.0)
        for k, c, impl in cs.ASYNC_PLANS:
            for driver in cs.ASYNC_DRIVERS:
                out[cs.async_key(k, c, impl, driver)] = run(ctx, k, c, impl, driver,
                                                            cs.MAIN_MIN_SUPPORT)
        k, c, impl, mb = cs.ASYNC_SMALL_BATCH
        out[cs.async_key(k, c, impl, "mrganter+", mb)] = run(
            ctx, k, c, impl, "mrganter+", cs.MAIN_MIN_SUPPORT, max_batch=mb)
        k, c, impl, cap = cs.ASYNC_GANTER
        out[cs.async_key(k, c, impl, "mrganter", max_iterations=cap)] = run(
            ctx, k, c, impl, "mrganter", cs.MAIN_MIN_SUPPORT, max_iterations=cap)
        cctx, _ = fca_datasets.load("census-income", scale=1.0)
        k, c, impl = cs.ASYNC_CENSUS_PLAN
        out["census " + cs.async_key(k, c, impl, "mrganter+")] = run(
            cctx, k, c, impl, "mrganter+", cs.CENSUS_MIN_SUPPORT)
    jax.clear_caches()
    return out


def load_constants() -> dict:
    """The reference values of chip_smoke.py's serve-under-load phase (15).

    For every run of ``LOAD_VIRTUAL``, the JAX package (``backend="jnp"``,
    under the binding above) serves chip_smoke's seeded arrivals and
    workload through its ``AdmissionQueue`` and ``run_load`` on a virtual
    clock (chip_smoke's ``virtual_load``, the queue repaired by
    ``repair_livelock``) over the stores those runs use: mushroom at
    ``MAIN_MIN_SUPPORT`` on k = 1 and 8 rsag; mushroom mined at
    ``RULES_MIN_SUPPORT`` on k = 8 rsag with its rule index at
    ``RULES_MIN_CONF``; the full lattice of mushroom at scale 0.01 on k = 8
    with streamed updates.  Records chip_smoke's ``load_record`` (with the
    final snapshot's version and intents for the stream run) and the
    ``serve_load`` keys the reference CLI prints.  Minutes on a CPU; run it
    as ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py load``
    and copy the printed JSON into chip_smoke.py's ``LOAD_EXPECTED`` and
    ``LOAD_KEYS``.
    """
    import contextlib
    import io
    import json
    import sys
    from pathlib import Path

    import repro.core as ref_core
    import repro.serve as ref_serve
    from repro.data import fca_datasets
    from repro.dist.shardplan import ShardPlan
    from repro.launch import fca as ref_fca
    from repro.query import ConceptStore, QueryEngine, StreamUpdater
    from repro.query.engine import QueryConfig
    from repro.rules import RuleIndex, extract_bases

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    expected = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "axis_frame", lambda name: jax.lax.axis_size(name),
                   raising=False)
        ctx, _ = fca_datasets.load("mushroom", scale=1.0)
        intents = ref_core.mrcbo(ctx, ref_core.ClosureEngine(ctx, backend="jnp"),
                                 min_support=cs.MAIN_MIN_SUPPORT).intents
        plan = ShardPlan.simulated(8, reduce_impl="rsag")
        res = ref_core.mrganter_plus(ctx, ref_core.ClosureEngine(ctx, plan=plan, backend="jnp"),
                                     local_prune=True, min_support=cs.RULES_MIN_SUPPORT)
        rules_store = ConceptStore.build(ctx, res.intents, plan=plan)
        index = RuleIndex.build(extract_bases(rules_store, min_conf=cs.RULES_MIN_CONF),
                                plan=plan)
        sctx, _ = fca_datasets.load("mushroom", scale=0.01)
        sintents = ref_core.mrcbo(sctx, ref_core.ClosureEngine(sctx, backend="jnp")).intents
        for run, (source, *_) in cs.LOAD_VIRTUAL.items():
            run_ctx, rules_index, updater = ctx, None, None
            if source == "serve":
                k = int(run.split("k=")[1])
                store = ConceptStore.build(ctx, intents,
                                           plan=ShardPlan.simulated(k, reduce_impl="rsag"))
            elif source == "rules":
                store, rules_index = rules_store, index
            else:
                run_ctx = sctx
                store = ConceptStore.build(sctx, sintents, plan=ShardPlan.simulated(8))
                updater = StreamUpdater(store)
            qe = QueryEngine(store, QueryConfig(slots=cs.SERVE_SLOTS, backend="jnp"))
            rep, tickets = cs.virtual_load(ref_serve, run_ctx, qe, run,
                                           rules_index=rules_index, updater=updater,
                                           prepare=repair_livelock)
            rec = cs.load_record(rep, tickets)
            if updater is not None:
                rec.update(version=store.snapshot.version,
                           intents_sha256=cs.digest(store.snapshot.intents_np))
            expected[run] = rec
            print(run, json.dumps(rec), file=sys.stderr, flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref_fca.main(["serve", "--dataset", "mushroom", "--scale", "0.01", "--parts", "2",
                          "--min-support", "0.3", "--backend", "jnp", "--queries", "16",
                          "--topk", "8", "--load-qps", "50", "--load-seconds", "0.2"])
        keys = sorted(json.loads(buf.getvalue())["serve_load"])
    jax.clear_caches()
    return {"expected": expected, "keys": keys}


def lm_constants() -> dict:
    """The reference tokens of chip_smoke.py's reduced LM serve phase.

    For each arch of ``LM_REDUCED_ARCHS``, the JAX package's
    ``ServeEngine`` (greedy, the reference CLI's ``ServeConfig``) is handed
    the numpy parity tree ``repro_torch.interop.numpy_params(cfg,
    LM_SEED)`` — the very leaves the port loads through ``params_from_jax``
    on the card — and chip_smoke's prompts.  Needs no jax binding (the LM
    reference does not call ``axis_frame``); a few seconds on a CPU.  Run
    it as ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py lm``
    and copy the printed JSON into chip_smoke.py's ``LM_REDUCED_EXPECTED``.
    """
    import sys
    from pathlib import Path

    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.serve.engine import ServeConfig, ServeEngine
    from repro_torch.interop import numpy_params

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    out = {}
    for arch in cs.LM_REDUCED_ARCHS:
        cfg = get_config(arch).reduced()
        values = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, cs.LM_SEED))
        prompts = cs.lm_prompts_for(arch, cfg.vocab_size)
        eng = ServeEngine(cfg, values, ServeConfig(max_len=cs.LM_REDUCED_MAX_LEN,
                                                   batch_slots=max(4, len(prompts))))
        out[arch] = eng.generate(prompts, cs.LM_MAX_NEW)
    return out


def train_constants() -> dict:
    """The reference losses of chip_smoke.py's reduced train phase (19).

    For each arch of ``repro.configs``, ``reduced()``: the JAX package's
    jitted ``make_train_step`` with the arch plan's optimizer at
    ``warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_REDUCED_STEPS)`` on the
    numpy parity tree ``numpy_params(cfg, LM_SEED)`` and the step-indexed
    corpus at ``TRAIN_REDUCED_SHAPE`` (seed 0), each step's loss.  Needs no
    jax binding; a minute or two on a CPU.  Run it as
    ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_torch_reference.py train``
    and copy the printed JSON into chip_smoke.py's
    ``TRAIN_REDUCED_EXPECTED``."""
    import sys
    from pathlib import Path

    import jax.numpy as jnp

    from repro.configs import ARCH_IDS, get_config, get_plan
    from repro.data.lm_data import make_batch_iterator
    from repro.models.config import ShapeConfig
    from repro.train.optim import get_optimizer, warmup_cosine
    from repro.train.step import make_train_step
    from repro_torch.interop import numpy_params

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    out = {}
    shape = ShapeConfig("reduced", "train", *cs.TRAIN_REDUCED_SHAPE)
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        opt = get_optimizer(get_plan(arch).optimizer,
                            warmup_cosine(cs.TRAIN_LR, cs.TRAIN_WARMUP, cs.TRAIN_REDUCED_STEPS))
        params = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, cs.LM_SEED))
        state = {"params": params, "opt": opt.init(params), "step": jnp.zeros((), jnp.int32)}
        step = jax.jit(make_train_step(cfg, opt, None))
        it = make_batch_iterator(cfg, shape, seed=0)
        losses = []
        for _ in range(cs.TRAIN_REDUCED_STEPS):
            _, batch = next(it)
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(metrics["loss"]))
        out[arch] = losses
    return out


if __name__ == "__main__":
    import json
    import sys

    if sys.argv[1:] == ["lm"]:
        print(json.dumps(lm_constants()))
    elif sys.argv[1:] == ["train"]:
        print(json.dumps(train_constants()))
    elif sys.argv[1:] == ["cand"]:
        print(json.dumps(cand_constants(), indent=1))
    elif sys.argv[1:] == ["async"]:
        print(json.dumps(async_constants(), indent=1))
    elif sys.argv[1:] == ["load"]:
        print(json.dumps(load_constants(), indent=1))
    else:
        print(json.dumps(smoke_constants(), indent=1))
