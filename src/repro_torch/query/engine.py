"""QueryEngine — fixed-slot micro-batched SPMD serving over a ConceptStore.

Requests pad into fixed ``slots``-wide micro-batches and each micro-batch
executes as ONE plan round —

  * ``closure``  — closure-of-attrset: per-shard local closure over the
    object-sharded context (K1 over ``[k, N/k, W]`` in one launch for
    ``backend="kernel"``) → AND-allreduce (+ the sum of supports) →
    two-level-hash concept lookup, inside one ``ShardPlan.spmd`` region.
    B queries cost one collective round, not B.
  * ``top_k``    — the same closure round with a contains-mask × supports
    top-k stage instead of the lookup (K5 for ``backend="kernel"``).
  * ``extents``  — per-shard extent-table column gather + one all-gather.
  * ``lookup`` / ``supers`` / ``subs`` / ``children`` / ``parents`` /
    ``rules`` — replicated-table reads: zero collective rounds (``rules``
    runs K6 for ``backend="kernel"``).

The steps close over the *plan*, never over a snapshot: snapshot tables
arrive as arguments, so a streaming commit (a new lattice version) reuses
the cached steps.  With ``plan.reduce_impl == "auto"`` each micro-batch
resolves allgather-vs-rsag from its padded slot count
(``plan.resolve_impl``) and the choice is recorded in ``stats``.

Every micro-batch records a ``query/micro_batch`` span on the current
tracer (:mod:`repro_torch.obs`) and its service time, on the engine's
injectable ``clock``, in ``stats.latency_percentiles["micro_batch"]`` and
the per-kind ``service_s`` histograms of the stats registry.

Backends are those of the mining engine: ``kernel`` (K1, K5, K6),
``torch`` (their plain versions, the reference's jnp steps) and
``matmul`` (the closure as complement-plane matrix products, the serving
stages as ``torch``).
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.device import device_bits, host_bits, pack_lanes
from repro_torch.dist import collectives
from repro_torch.kernels import ops
from repro_torch.kernels import serve as skern
from repro_torch.obs import StatsBase
from repro_torch.obs import trace as obs
from repro_torch.query.store import ConceptStore, lookup_ids

BACKENDS = ("kernel", "torch", "matmul")


@dataclasses.dataclass
class QueryStats(StatsBase):
    """Serving-side stats: the schedule census (``reduce_rounds`` /
    ``auto_hop_bytes`` / ``hop_calibrated``) and ``latency_percentiles``
    inherited from :class:`repro_torch.obs.StatsBase` — one definition
    shared with the mining engine's ``EngineStats`` — plus the query
    census."""

    queries: int = 0
    micro_batches: int = 0
    collective_rounds: int = 0
    modeled_comm_bytes: int = 0
    by_type: dict = dataclasses.field(default_factory=dict)

    def charge(self, kind: str, n: int, batches: int):
        self.queries += n
        self.micro_batches += batches
        self.by_type[kind] = self.by_type.get(kind, 0) + n


@dataclasses.dataclass
class QueryConfig:
    slots: int = 64  # fixed micro-batch width; every dispatch pads to this
    backend: str = "kernel"  # closure map + serving stages, as in ClosureEngine


class QueryEngine:
    def __init__(
        self, store: ConceptStore, cfg: QueryConfig | None = None, *, clock=time.perf_counter
    ):
        self.store = store
        self.cfg = cfg or QueryConfig()
        # the clock of the micro-batch service timings (a caller running a
        # virtual timebase passes its own)
        self.clock = clock
        if self.cfg.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.cfg.backend!r}; choose {BACKENDS}")
        if self.cfg.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.cfg.slots}")
        self.plan = store.plan
        self.device = store.device
        self.n_attrs = store.ctx.n_attrs
        self.W = store.ctx.W
        self.stats = QueryStats(
            auto_hop_bytes=self.plan.auto_hop_bytes,
            hop_calibrated=self.plan.hop_calibrated,
        )
        self._mask_np = bitset.attr_mask(self.n_attrs, self.W)
        self._mask = device_bits(self._mask_np, self.device)
        # step caches, keyed by everything a step closes over.  Guarded by
        # ``_steps_lock``: two serving threads can miss a cold key at once,
        # and an unguarded check-then-set would build the same step twice.
        self._steps_lock = threading.Lock()
        self._closure_steps: dict = {}  # (impl, probe) -> step
        self._topk_steps: dict = {}  # (impl, k) -> step
        self._rules_steps: dict = {}  # k -> step (the metric is an operand)
        self._extent_step = None

    def _cached(self, cache: dict, key, make):
        step = cache.get(key)  # racy fast path, re-checked under the lock
        if step is not None:
            return step
        with self._steps_lock:
            step = cache.get(key)
            if step is None:
                step = cache[key] = make()
        return step

    # -- step builders (close over plan/config only) ------------------------

    def _local_closure(self, rows_local, cands):
        """Per-shard map: masked local closures + raw local supports (the
        global pad is corrected after the support sum)."""
        n_local = rows_local.shape[-2]
        if self.cfg.backend == "matmul":
            return ops.closure_matmul(rows_local, cands, self.n_attrs, n_valid_rows=n_local)
        return ops.batched_closure(
            rows_local, cands, self.n_attrs, n_valid_rows=n_local,
            use_kernel=self.cfg.backend == "kernel", mask=self._mask,
        )

    def _closure_body(self, impl: str):
        axes, n_attrs, mask = self.plan.reduce_axes, self.n_attrs, self._mask

        def body(rows_local, cands, n_pad):
            lc, ls = self._local_closure(rows_local, cands)
            gc = collectives.and_allreduce(lc, axes, impl=impl, n_attrs=n_attrs)
            return gc & mask, collectives.sum_allreduce(ls, axes) - n_pad

        return body

    def _closure_step(self, impl: str, probe: int):
        n_attrs = self.n_attrs

        def make():
            def post(gc, gs, intents, skeys, n_concepts):
                ids = lookup_ids(gc, intents, skeys, n_concepts, n_attrs=n_attrs, probe=probe)
                return gc, gs, ids

            return self.plan.spmd(self._closure_body(impl), n_rep=2, post=post, n_post_rep=3)

        return self._cached(self._closure_steps, (impl, probe), make)

    def _topk_step(self, impl: str, k: int):
        cfg = self.cfg

        def make():
            def post(gc, gs, intents, supports, n_concepts):
                # concepts whose intent ⊇ the query attrset == subconcepts
                # of closure(attrset); masked top-k by support: K5 for the
                # kernel backend, its plain version otherwise
                if cfg.backend == "kernel":
                    idx, vals = skern.contains_topk(gc, intents, supports, n_concepts, k=k)
                else:
                    idx, vals = skern.contains_topk_plain(gc, intents, supports, n_concepts,
                                                          k=k)
                return gc, gs, idx, vals

            return self.plan.spmd(self._closure_body(impl), n_rep=2, post=post, n_post_rep=3)

        return self._cached(self._topk_steps, (impl, k), make)

    def _extents_step(self):
        axes = self.plan.reduce_axes

        def make():
            def body(ext_local, ids):
                # [.., Nl, B] membership bits of each queried concept's column
                w = ext_local[..., ids // 32]
                b = (w >> (ids % 32).to(torch.int32)) & 1
                return collectives.all_gather_rows(b, axes)  # [Np, B]

            def post(bits):
                return pack_lanes(bits.T, -(-bits.shape[0] // 32))  # [B, Wo]

            return self.plan.spmd(body, n_rep=1, post=post)

        if self._extent_step is None:
            with self._steps_lock:
                if self._extent_step is None:
                    self._extent_step = make()
        return self._extent_step

    def _rules_step(self, k: int):
        # keyed by k alone: the rank metric arrives as a run-time operand,
        # so confidence- and lift-ranked queries share one step
        cfg = self.cfg

        def make():
            def run(prem, added, conf, metric, rid, n_rules, queries, min_conf):
                # premise-subset test → confidence mask → consequent union →
                # metric top-k: K6 for the kernel backend, its plain
                # version otherwise
                if cfg.backend == "kernel":
                    return skern.rules_topk(prem, added, conf, metric, rid, n_rules,
                                            queries, min_conf, k=k)
                return skern.rules_topk_plain(prem, added, conf, metric, rid, n_rules,
                                              queries, min_conf, k=k)

            return run

        return self._cached(self._rules_steps, k, make)

    # -- micro-batch plumbing ----------------------------------------------

    def _chunks(self, arr: np.ndarray):
        """Yield ``(lo, n_valid, chunk)`` with every chunk padded to the
        fixed slot width.  Callers return early on empty batches."""
        S = self.cfg.slots
        for lo in range(0, arr.shape[0], S):
            chunk = arr[lo : lo + S]
            b = chunk.shape[0]
            if b < S:
                pad = np.zeros((S - b, *arr.shape[1:]), arr.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            yield lo, b, chunk

    def _obs_batch(self, kind: str, dt: float, version: int | None = None):
        """One micro-batch's telemetry: the ``micro_batch`` percentile key,
        the per-kind ``service_s`` histogram, a dispatch counter and the
        snapshot-version gauge, all in the stats registry."""
        st = self.stats
        st.observe_latency("micro_batch", dt)
        reg = st.registry
        reg.observe("service_s", dt, kind=kind)
        reg.counter("micro_batches_total", kind=kind)
        if version is not None:
            reg.gauge("snapshot_version", version)

    def _charge_round(self, cap: int) -> str:
        impl = self.plan.resolve_impl(cap, self.W, self.n_attrs)
        st = self.stats
        st.collective_rounds += 1
        st.record_reduce(impl)
        st.modeled_comm_bytes += collectives.modeled_comm_bytes(
            impl, self.plan.n_parts, cap, self.W, self.n_attrs
        )
        return impl

    # -- queries ------------------------------------------------------------

    def closure_batch(
        self, attrsets: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Closure-of-attrset for [B, W] packed queries → (closed intents
        [B, W], supports [B], concept ids [B]).  One SPMD round per
        micro-batch; ids resolve against the snapshot read at entry."""
        st = self.store.state  # one consistent (rows, snapshot) view
        snap, rows, n_pad = st.snapshot, st.rows, st.n_pad
        attrsets = np.ascontiguousarray(attrsets, np.uint32) & self._mask_np
        B = attrsets.shape[0]
        out_c = np.empty((B, self.W), np.uint32)
        out_s = np.empty((B,), np.int32)
        out_i = np.empty((B,), np.int32)
        if B == 0:
            self.stats.charge("closure", 0, 0)
            return out_c, out_s, out_i
        batches = 0
        for lo, b, chunk in self._chunks(attrsets):
            t0 = self.clock()
            with obs.current().span("query/micro_batch", kind="closure", slots=chunk.shape[0]):
                impl = self._charge_round(chunk.shape[0])
                gc, gs, ids = self._closure_step(impl, snap.probe)(
                    rows, device_bits(chunk, self.device), n_pad,
                    snap.intents, snap.skeys, snap.n_concepts,
                )
                out_c[lo : lo + b] = host_bits(gc)[:b]
                out_s[lo : lo + b] = gs.cpu().numpy()[:b]
                out_i[lo : lo + b] = ids.cpu().numpy()[:b]
            self._obs_batch("closure", self.clock() - t0, snap.version)
            batches += 1
        self.stats.charge("closure", B, batches)
        return out_c, out_s, out_i

    def topk_batch(
        self, attrsets: np.ndarray, k: int = 5
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k concepts by support containing each query attrset →
        (ids [B, k], supports [B, k]); -1 id pads when fewer match."""
        st = self.store.state
        snap, rows, n_pad = st.snapshot, st.rows, st.n_pad
        attrsets = np.ascontiguousarray(attrsets, np.uint32) & self._mask_np
        B = attrsets.shape[0]
        out_i = np.empty((B, k), np.int32)
        out_v = np.empty((B, k), np.int32)
        if B == 0:
            self.stats.charge("topk", 0, 0)
            return out_i, out_v
        batches = 0
        for lo, b, chunk in self._chunks(attrsets):
            t0 = self.clock()
            with obs.current().span("query/micro_batch", kind="topk", slots=chunk.shape[0]):
                impl = self._charge_round(chunk.shape[0])
                _, _, idx, vals = self._topk_step(impl, k)(
                    rows, device_bits(chunk, self.device), n_pad,
                    snap.intents, snap.supports, snap.n_concepts,
                )
                out_i[lo : lo + b] = idx.cpu().numpy()[:b]
                out_v[lo : lo + b] = vals.cpu().numpy()[:b]
            self._obs_batch("topk", self.clock() - t0, snap.version)
            batches += 1
        self.stats.charge("topk", B, batches)
        return out_i, out_v

    def lookup_batch(self, intents: np.ndarray) -> np.ndarray:
        """Concept ids for already-closed intents [B, W]; -1 for misses.
        Replicated-table read — no collective round."""
        snap = self.store.snapshot
        intents = np.ascontiguousarray(intents, np.uint32)
        B = intents.shape[0]
        out = np.empty((B,), np.int32)
        if B == 0:
            self.stats.charge("lookup", 0, 0)
            return out
        batches = 0
        for lo, b, chunk in self._chunks(intents):
            t0 = self.clock()
            with obs.current().span("query/micro_batch", kind="lookup", slots=chunk.shape[0]):
                ids = lookup_ids(
                    device_bits(chunk, self.device), snap.intents, snap.skeys,
                    snap.n_concepts, n_attrs=self.n_attrs, probe=snap.probe,
                )
                out[lo : lo + b] = ids.cpu().numpy()[:b]
            self._obs_batch("lookup", self.clock() - t0, snap.version)
            batches += 1
        self.stats.charge("lookup", B, batches)
        return out

    def _order_query(self, ids, table: torch.Tensor, kind: str):
        snap = self.store.snapshot
        ids = np.asarray(ids, np.int32)
        safe = np.clip(ids, 0, snap.cap - 1)
        rows = host_bits(table[torch.from_numpy(safe).to(table.device).long()])
        self.stats.charge(kind, ids.shape[0], 1)
        out = []
        for r, i in zip(rows, ids):
            if i < 0 or i >= snap.n_concepts:
                out.append(np.zeros((0,), np.int32))
            else:
                out.append(np.nonzero(bitset.unpack_bits(r, snap.cap))[0].astype(np.int32))
        return out

    def supers(self, ids) -> list[np.ndarray]:
        """All strict superconcepts (smaller intents) per queried id."""
        return self._order_query(ids, self.store.snapshot.sup_rows, "supers")

    def subs(self, ids) -> list[np.ndarray]:
        """All strict subconcepts (larger intents) per queried id."""
        return self._order_query(ids, self.store.snapshot.sub_rows, "subs")

    def children(self, ids) -> list[np.ndarray]:
        """Covering-relation reads: the ids each concept covers
        (``ConceptLattice.children`` convention)."""
        return self._order_query(ids, self.store.snapshot.children_rows, "children")

    def parents(self, ids) -> list[np.ndarray]:
        return self._order_query(ids, self.store.snapshot.parents_rows, "parents")

    def extents_batch(self, ids) -> np.ndarray:
        """Packed object extents [B, Wo] for concept ids (one all-gather
        round over the object-sharded extent table per micro-batch)."""
        st = self.store.state
        snap = st.snapshot
        ids = np.asarray(ids, np.int32)
        B = ids.shape[0]
        Wo = -(-st.N_padded // 32)
        out = np.empty((B, Wo), np.uint32)
        if B == 0:
            self.stats.charge("extents", 0, 0)
            return out
        step = self._extents_step()
        batches = 0
        for lo, b, chunk in self._chunks(np.clip(ids, 0, snap.cap - 1)):
            t0 = self.clock()
            with obs.current().span("query/micro_batch", kind="extents", slots=chunk.shape[0]):
                packed = step(snap.ext_cols, torch.from_numpy(chunk).to(self.device).long())
                out[lo : lo + b] = host_bits(packed)[:b]
            self._obs_batch("extents", self.clock() - t0, snap.version)
            batches += 1
            self.stats.collective_rounds += 1
            # the round's all-gather moves each shard's [Nl, B] membership
            # words to every peer: k·(k-1) rings × [Nl, B] words, the
            # whole-collective convention modeled_comm_bytes uses
            if self.plan.n_parts > 1:
                self.stats.record_reduce("allgather")
                n_local = st.N_padded // self.plan.n_parts
                self.stats.modeled_comm_bytes += (
                    self.plan.n_parts * (self.plan.n_parts - 1) * n_local * chunk.shape[0] * 4
                )
        # misses / out-of-snapshot ids get the empty extent, mirroring
        # _order_query's empty result (never another concept's objects)
        out[(ids < 0) | (ids >= snap.n_concepts)] = 0
        self.stats.charge("extents", B, batches)
        return out

    # -- rule queries (repro_torch.rules.RuleIndex) --------------------------

    RANK_BY = ("confidence", "lift")

    def rules_batch(
        self,
        index,
        attrsets: np.ndarray,
        *,
        k: int = 5,
        min_conf: float = 0.0,
        rank_by: str = "confidence",
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched rule lookup against a :class:`repro_torch.rules.RuleIndex`.

        For each query attrset: the top-``k`` applicable rules (premise ⊆
        attrset, confidence ≥ ``min_conf``) ranked by ``rank_by`` ∈
        {confidence, lift}, and the premise→consequent closure — the union
        of every firing rule's added attributes.  Returns ``(rule ids
        [B, k] (-1 pads), scores [B, k], consequents [B, W])``.
        Replicated-table read, fixed-slot micro-batches, zero collective
        rounds.
        """
        if rank_by not in self.RANK_BY:
            raise ValueError(f"unknown rank_by {rank_by!r}; choose {self.RANK_BY}")
        attrsets = np.ascontiguousarray(attrsets, np.uint32) & self._mask_np
        B = attrsets.shape[0]
        out_i = np.empty((B, k), np.int32)
        out_s = np.empty((B, k), np.float32)
        out_c = np.empty((B, self.W), np.uint32)
        if B == 0:
            self.stats.charge("rules", 0, 0)
            return out_i, out_s, out_c
        metric = index.confidence if rank_by == "confidence" else index.lift
        step = self._rules_step(k)
        batches = 0
        for lo, b, chunk in self._chunks(attrsets):
            t0 = self.clock()
            with obs.current().span("query/micro_batch", kind="rules", slots=chunk.shape[0]):
                idx, vals, union = step(
                    index.premise, index.added, index.confidence, metric,
                    index.rule_id, index.n_rules, device_bits(chunk, self.device),
                    np.float32(min_conf),
                )
                out_i[lo : lo + b] = idx.cpu().numpy()[:b]
                out_s[lo : lo + b] = vals.cpu().numpy()[:b]
                out_c[lo : lo + b] = host_bits(union)[:b]
            self._obs_batch("rules", self.clock() - t0)
            batches += 1
        self.stats.charge("rules", B, batches)
        return out_i, out_s, out_c

    def describe(self) -> dict:
        return {
            "slots": self.cfg.slots,
            "backend": self.cfg.backend,
            "plan": self.plan.describe(),
            "stats": dataclasses.asdict(self.stats),
        }
