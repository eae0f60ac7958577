"""Pass 1 — the SPMD audit, by recording what each step does.

The JAX package traces every cached step to a jaxpr and reads its
collectives off the trace.  Torch has no such trace, so this pass *runs*
each step on seeded inputs and records what it does at the port's one
collective seam, the entry points of :mod:`repro_torch.dist.collectives`
(``and_allreduce``, ``sum_allreduce``, ``all_gather_rows``,
``all_gather_blocks``, and ``folded_allreduce``, K4's fold of a simulated
plan's partials, which moves nothing but is the round's reduce).  On a
``torch.distributed`` group the primitives underneath
(``all_to_all_single``, ``all_gather_into_tensor``, ``all_reduce``) are
recorded as well.  Three contracts are checked against the plan's analytic
model, on every cached step of the sweep:

1. **axis binding & schedule order** — every collective binds only the
   plan's axes (the candidate axis only in a 2-D step); object-axis
   collectives come before any candidate-axis gather; the reduce runs the
   plan's schedule, once: rsag all_to_all → all_gather, allgather one
   all_gather (on a group, the primitives really run are held against
   that); a 2-D step gathers its survivors once along the candidate axis.

2. **wire-byte census** — the bytes the recorded collectives move, summed
   with the whole-collective ring convention ``modeled_comm_bytes`` uses
   (:func:`_ring_bytes`) times the number of independent rings, equal
   ``plan.modeled_reduce_bytes`` / ``plan.modeled_round_bytes_cand``.
   Closure words (the AND-allreduce's operand, a 2-D step's survivor
   blocks, the extents' membership words) are the modeled traffic;
   supports and counts are sideband — recorded, never counted.

3. **region hygiene** — no host read inside a step call.  A
   ``TorchFunctionMode`` records ``item``, ``tolist``, ``cpu``, ``numpy``
   and the ``__bool__`` / ``__int__`` / ``__float__`` / ``__index__``
   conversions of a tensor, and ``torch.tensor`` / ``torch.as_tensor`` (a
   tensor made from host data: on a card, a synchronising copy); on a CUDA
   device each step call also runs under
   ``torch.cuda.set_sync_debug_mode("error")``, after a positive control
   that a host read there raises.

The sweep runs on the card when one is present, else on the CPU, where the
kernel wrappers run their plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.findings import Finding
from repro_torch.dist import collectives

GEOMETRIES = ((1, 1), (4, 1), (2, 4))
IMPLS = ("rsag", "allgather")
BACKENDS = ("torch", "kernel")
HOST_READS = frozenset(
    ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__",
     "tensor", "as_tensor")
)


def _ring_bytes(prim: str, k: int, nbytes: int) -> int:
    """Whole-collective wire bytes for ONE ring of ``k`` devices moving a
    per-device operand of ``nbytes`` (the ``modeled_comm_bytes``
    convention: every device's traffic summed)."""
    if k <= 1:
        return 0
    if prim in ("all_gather", "pmin", "pmax"):
        return k * (k - 1) * nbytes
    if prim == "all_to_all":
        # operand carries the leading ring axis: each device keeps 1/k
        return (k - 1) * nbytes
    if prim in ("psum", "reduce_scatter"):
        return (k - 1) * nbytes if prim == "reduce_scatter" else 2 * (k - 1) * nbytes
    return k * nbytes  # ppermute/pbroadcast: one full-operand hop per device


@dataclasses.dataclass(frozen=True)
class Wire:
    """One wire primitive: its name and its per-device operand bytes."""

    prim: str
    nbytes: int


@dataclasses.dataclass
class Collective:
    """One entry-point call recorded inside a region, in schedule order."""

    index: int
    op: str  # the collectives entry point
    axis: str  # "object" | "candidate" | "undeclared:<axis>"
    shape: tuple[int, ...]
    ring_k: int  # devices per ring
    ring_count: int  # independent rings
    modeled: bool  # counted by the analytic model (closure words)
    folded: bool  # K4's in-kernel fold: recorded, nothing ran
    derived: tuple[Wire, ...]  # the primitives the schedule runs
    observed: list = dataclasses.field(default_factory=list)  # on a group

    @property
    def wire(self) -> tuple[Wire, ...]:
        """What moved: the primitives a group ran, else the schedule's."""
        return tuple(self.observed) if self.observed else self.derived

    @property
    def prims(self) -> list[str]:
        return [w.prim for w in self.wire]

    @property
    def bytes_total(self) -> int:
        return self.ring_count * sum(_ring_bytes(w.prim, self.ring_k, w.nbytes)
                                     for w in self.wire)


def _same_axis(a, b) -> bool:
    if isinstance(a, str) or isinstance(b, str):
        return isinstance(a, str) and isinstance(b, str) and a == b
    return a is b


def _axis_name(axis) -> str:
    if isinstance(axis, str):
        return axis
    import torch.distributed as dist

    return "group" + str(dist.get_process_group_ranks(axis))


class Recorder:
    """Receives every entry point's operand (``collectives.set_recorder``)
    and, through :class:`_RecordingDist`, the primitives a group runs.

    ``two_d`` declares the plan's candidate axis and splits a simulated
    plan's object reduce into ``cand_parts`` rings of one block each: a
    simulated 2-D step closes its whole chunk in one call, which is what
    ``cand_parts`` block-sized reduces compute."""

    def __init__(self, plan, W: int, *, two_d: bool = False):
        self.plan = plan
        self.W = W
        self.two_d = two_d
        self.records: list[Collective] = []
        self.host_reads: list[str] = []
        self._current: Collective | None = None

    # -- what the seam calls ------------------------------------------------

    def collective(self, op: str, x: torch.Tensor, axis, *, impl: str | None = None,
                   n_attrs: int | None = None, folded: bool = False) -> None:
        plan, cp = self.plan, self.plan.cand_parts
        simulated = isinstance(axis, str)
        if _same_axis(axis, plan.reduce_axes):
            role = "object"
        elif self.two_d and plan.cand_axes is not None and _same_axis(axis, plan.cand_axes):
            role = "candidate"
        else:
            role = "undeclared:" + _axis_name(axis)
        if simulated:
            k = x.shape[0]
            dev = (1, *x.shape[1:]) if op == "all_gather_blocks" else tuple(x.shape[1:])
        else:
            import torch.distributed as dist

            k = dist.get_world_size(axis)
            dev = tuple(x.shape)
        rings = 1
        if role == "candidate":
            rings = plan.n_parts
        elif role == "object" and self.two_d and cp > 1:
            rings = cp
            if simulated and dev and dev[0] % cp == 0:
                dev = (dev[0] // cp, *dev[1:])  # one block of the whole chunk
        itemsize = x.element_size()
        nbytes = math.prod(dev) * itemsize
        if op == "and_allreduce":
            modeled = True
            derived = self._reduce_wire(impl, k, dev, n_attrs)
        elif op == "sum_allreduce":
            modeled = False
            derived = (Wire("psum", nbytes),) if k > 1 else ()
        else:  # the gathers: extents' membership words, survivor blocks
            modeled = op == "all_gather_rows" or (x.dim() == 3 and x.shape[-1] == self.W)
            derived = (Wire("all_gather", nbytes),) if k > 1 else ()
        rec = Collective(len(self.records), op, role, tuple(x.shape), k, rings, modeled,
                         folded, derived)
        self.records.append(rec)
        self._current = rec

    @staticmethod
    def _reduce_wire(impl, k: int, dev: tuple, n_attrs) -> tuple[Wire, ...]:
        """The AND-allreduce's primitives for a per-device ``[B, W]`` block,
        as :func:`collectives.and_allreduce` runs them on a group."""
        if k <= 1:
            return ()
        B, W = dev[-2], dev[-1]
        if impl == "rsag":
            Bp = B + (-B % k)
            return Wire("all_to_all", Bp * W * 4), Wire("all_gather", Bp // k * W * 4)
        if impl == "allgather":
            return (Wire("all_gather", B * W * 4),)
        m = n_attrs if n_attrs is not None else W * 32
        return (Wire("pmin", B * m * 4),)

    def primitive(self, prim: str, x: torch.Tensor) -> None:
        """A primitive a group ran, charged to the entry point running it."""
        if self._current is not None:
            self._current.observed.append(Wire(prim, x.numel() * x.element_size()))

    # -- readings -------------------------------------------------------------

    def modeled_bytes(self) -> int:
        return sum(r.bytes_total for r in self.records if r.modeled)

    def summary(self) -> list[dict]:
        return [{"op": r.op, "axis": r.axis, "prims": r.prims, "bytes": r.bytes_total,
                 "modeled": r.modeled, "folded": r.folded} for r in self.records]


class _RecordingDist:
    """``torch.distributed`` as :mod:`repro_torch.dist.collectives` sees it
    while a recorder is installed: the three primitives it runs are
    reported, everything else passes through."""

    def __init__(self, real, recorder: Recorder):
        self._real = real
        self._rec = recorder

    def __getattr__(self, name):
        return getattr(self._real, name)

    def all_gather_into_tensor(self, out, x, *args, **kw):
        self._rec.primitive("all_gather", x)
        return self._real.all_gather_into_tensor(out, x, *args, **kw)

    def all_to_all_single(self, out, x, *args, **kw):
        self._rec.primitive("all_to_all", x)
        return self._real.all_to_all_single(out, x, *args, **kw)

    def all_reduce(self, x, *args, **kw):
        op = kw.get("op", args[0] if args else self._real.ReduceOp.SUM)
        self._rec.primitive("pmin" if op == self._real.ReduceOp.MIN else "psum", x)
        return self._real.all_reduce(x, *args, **kw)


class _HostReads(TorchFunctionMode):
    """Records every host read of a tensor made while it is active."""

    def __init__(self, reads: list):
        super().__init__()
        self.reads = reads

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_READS:
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def recording(plan, W: int, *, two_d: bool = False, hygiene: bool = True):
    """Record every collective (and, with ``hygiene``, every host read)
    made inside the block; yields the :class:`Recorder`."""
    rec = Recorder(plan, W, two_d=two_d)
    prev = collectives.set_recorder(rec)
    real_dist = collectives.dist
    collectives.dist = _RecordingDist(real_dist, rec)
    try:
        with _HostReads(rec.host_reads) if hygiene else contextlib.nullcontext():
            yield rec
    finally:
        collectives.dist = real_dist
        collectives.set_recorder(prev)


@contextlib.contextmanager
def sync_guard(device: torch.device):
    """On a CUDA device, a host read of a device value, a synchronising
    copy or a synchronisation inside the block raises."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _reduce_want(plan, impl: str) -> list[str]:
    if plan.n_parts <= 1:
        return []
    return {"rsag": ["all_to_all", "all_gather"], "allgather": ["all_gather"]}.get(impl, ["pmin"])


def check_region(
    label: str,
    rec: Recorder,
    *,
    impl: str,
    expected_bytes: int,
    expect_obj_pattern: bool = True,
) -> list[Finding]:
    """The three contracts, applied to one recorded step call."""
    out = []
    plan = rec.plan

    def err(rule, msg):
        out.append(Finding("spmd", rule, label, msg))

    if rec.host_reads:
        err("host-read-in-region", f"host reads {sorted(set(rec.host_reads))} inside the step")
    records = rec.records
    for c in records:
        if c.axis.startswith("undeclared:"):
            err("undeclared-axis", f"{c.op} binds axis {c.axis[11:]} outside the plan's "
                                   f"declared axes")
    obj = [c for c in records if c.axis == "object"]
    cand = [c for c in records if c.axis == "candidate"]
    if obj and cand and max(c.index for c in obj) > min(c.index for c in cand):
        err("cand-gather-before-reduce",
            f"candidate-axis {cand[0].op} at {min(c.index for c in cand)} precedes "
            f"object-axis {obj[-1].op} at {max(c.index for c in obj)}")
    for c in records:
        if c.observed and [w.prim for w in c.observed] != [w.prim for w in c.derived]:
            err("primitive-mismatch",
                f"{c.op} ran {[w.prim for w in c.observed]} on the group, its schedule is "
                f"{[w.prim for w in c.derived]}")
    if expect_obj_pattern:
        got = [p for c in obj if c.modeled for p in c.prims]
        want = _reduce_want(plan, impl)
        if got != want:
            err("reduce-schedule-mismatch",
                f"object-axis modeled collectives {got} != {want} for impl={impl!r} at "
                f"k={plan.n_parts}")
    if rec.two_d and plan.cand_parts > 1:
        got = [p for c in cand if c.modeled for p in c.prims]
        if got != ["all_gather"]:
            err("cand-gather-mismatch",
                f"expected exactly one modeled candidate-axis all_gather (the survivor "
                f"buffer), recorded {got}")
    recorded = rec.modeled_bytes()
    if recorded != expected_bytes:
        err("byte-census-mismatch",
            f"recorded modeled collective bytes {recorded} != analytic model "
            f"{expected_bytes} (" + "; ".join(
                f"{c.op}{list(c.shape)}x{c.ring_count}rings={c.bytes_total}B"
                for c in records if c.modeled) + ")")
    return out


def _is_sync_error(e: RuntimeError) -> bool:
    return "synchroniz" in str(e)


def audit_call(
    label: str,
    fn,
    args,
    *,
    plan,
    W: int,
    device: torch.device,
    impl: str | None = None,
    two_d: bool = False,
    expected_bytes: int = 0,
    expect_obj_pattern: bool = True,
    replicated: bool = False,
    guard: bool = True,
    log: dict | None = None,
) -> list[Finding]:
    """Run ``fn(*args)`` once, recording it, and check the contracts.

    ``replicated`` marks a pass over replicated tables, where any
    collective is a finding; ``guard`` runs the call under
    :func:`sync_guard` on a CUDA device.  ``log`` (a dict) receives the
    recorded collectives under ``label``."""
    try:
        with recording(plan, W, two_d=two_d) as rec:
            with sync_guard(device) if guard else contextlib.nullcontext():
                fn(*args)
    except RuntimeError as e:
        if _is_sync_error(e):
            return [Finding("spmd", "host-sync-in-region", label,
                            f"a synchronising call inside the step: {str(e).splitlines()[0]}")]
        return [Finding("spmd", "step-failure", label, f"{type(e).__name__}: {e}")]
    if log is not None:
        log[label] = rec.summary()
    if replicated:
        found = [Finding("spmd", "collective-in-replicated-pass", label,
                         f"{c.op} in a replicated pass") for c in rec.records]
        if rec.host_reads:
            found.append(Finding("spmd", "host-read-in-region", label,
                                 f"host reads {sorted(set(rec.host_reads))} inside the pass"))
        return found
    return check_region(label, rec, impl=impl or plan.reduce_impl,
                        expected_bytes=expected_bytes, expect_obj_pattern=expect_obj_pattern)


def self_test(device: torch.device) -> list[Finding]:
    """The hygiene checks' positive controls: a host read inside a recorded
    call must be seen by the mode, and on a CUDA device must raise under
    the guard — or the checks prove nothing."""
    from repro_torch.dist.shardplan import ShardPlan

    def reads_the_host():
        return int((torch.ones((), dtype=torch.int32, device=device) + 1).item())

    found = audit_call("self-test/host-read", reads_the_host, (), plan=ShardPlan.simulated(1),
                       W=1, device=device)
    rules = {f.rule for f in found}
    want = "host-sync-in-region" if device.type == "cuda" else "host-read-in-region"
    if want not in rules:
        return [Finding("spmd", "hygiene-blind", "self-test/host-read",
                        f"a host read inside a recorded step was not flagged ({want})")]
    return []


# ---------------------------------------------------------------------------
# frontier step sweep
# ---------------------------------------------------------------------------


def _frontier_ctx(n_attrs: int = 40, n_objects: int = 24):
    from repro_torch.core.context import FormalContext

    rng = np.random.default_rng(7)
    W = -(-n_attrs // 32)
    rows = rng.integers(0, 2**32, size=(n_objects, W), dtype=np.uint32)
    mask = np.full(W, 0xFFFFFFFF, np.uint32)
    tail = n_attrs % 32
    if tail:
        mask[-1] = (1 << tail) - 1
    return FormalContext(
        rows=rows & mask, n_objects=n_objects, n_attrs=n_attrs, attr_names=None
    )


def _step_args(name: str, engine, *, batch: int, cap_g: int, seed: int = 11) -> tuple:
    """Seeded operands for one frontier step variant, as the frontier
    passes them: the chunk (``batch`` candidates; the Alg.-5 walk's
    ``cap_g``-row seed chunk), lineage, the valid count and the iceberg
    threshold."""
    from repro_torch.device import device_bits

    ctx, dev = engine.ctx, engine.device
    rng = np.random.default_rng(seed)
    W, m = ctx.W, ctx.n_attrs
    mask = ctx.attr_mask()

    def subsets(n):
        rows = ctx.rows[rng.integers(0, ctx.n_objects, size=n)]
        return rows & rng.integers(0, 2**32, size=(n, W), dtype=np.uint32) & mask

    base = name[:-2] if name.endswith("2d") else name
    if base.startswith("ganter"):
        seeds = np.full((cap_g, W), 0xFFFFFFFF, np.uint32)
        seeds[:m] = subsets(m)
        Y = torch.from_numpy(subsets(1)[0].view(np.int32).copy()).to(dev)
        valid = torch.from_numpy(rng.random(m) < 0.8).to(dev)
        args = (device_bits(seeds, dev), Y, valid)
    else:
        cands = device_bits(subsets(batch), dev)
        n_valid = batch - 3
        if base.startswith("cbo"):
            parents = device_bits(subsets(batch), dev)
            gens = torch.from_numpy(rng.integers(0, m, size=batch).astype(np.int32)).to(dev)
            args = (cands, parents, gens, n_valid)
        elif base == "plain":
            args = (cands,)
        else:
            args = (cands, n_valid)
    if "iceberg" in base:
        args = args + (2,)
    return (engine.rows,) + args


def audit_plan_steps(report, plan, *, backends=BACKENDS, device=None, batch: int = 32,
                     label: str = "", log: dict | None = None) -> list[Finding]:
    """Run and check every cached frontier step of ``plan`` (one-axis and
    2-D, ``batch`` candidates: ``batch / cand_parts`` must stay a multiple
    of the engine's 8-row bucket) on each backend."""
    from repro_torch.core.engine import ClosureEngine
    from repro_torch.core.frontier import DeviceFrontier
    from repro_torch.kernels.ops import bucket_size

    ctx = _frontier_ctx()
    findings = []
    for backend in backends:
        engine = ClosureEngine(ctx, plan=plan, backend=backend, device=device)
        frontier = DeviceFrontier(engine)
        cap_g = bucket_size(ctx.n_attrs, minimum=engine.min_bucket)
        for name in sorted(frontier._cache["builders"]):
            two_d = name.endswith("2d")
            B = cap_g if name.startswith("ganter") else batch
            if two_d:
                expected = plan.modeled_round_bytes_cand(B // plan.cand_parts, ctx.W,
                                                         ctx.n_attrs)
                impl = plan.resolve_impl(B // plan.cand_parts, ctx.W, ctx.n_attrs)
            else:
                expected = plan.modeled_reduce_bytes(B, ctx.W, ctx.n_attrs)
                impl = plan.resolve_impl(B, ctx.W, ctx.n_attrs)
            findings.extend(audit_call(
                f"{label}{backend}/{name}", frontier._step_fn(name),
                _step_args(name, engine, batch=batch, cap_g=cap_g),
                plan=plan, W=ctx.W, device=engine.device, impl=impl, two_d=two_d,
                expected_bytes=expected, log=log,
            ))
            report.note_checked("spmd", "frontier_steps")
    return findings


def audit_frontier_steps(report, *, geometries=GEOMETRIES, impls=IMPLS, backends=BACKENDS,
                         device=None, batch: int = 32) -> list[Finding]:
    """Every cached frontier step variant — the torch steps and their fused
    kernel twins — under each (n_parts x cand_parts) geometry and reduce
    schedule of a simulated plan."""
    from repro_torch.dist.shardplan import ShardPlan

    ctx = _frontier_ctx()
    findings = []
    for n_parts, cand_parts in geometries:
        for impl in impls:
            plan = ShardPlan.simulated(
                n_parts, cand_parts=cand_parts, reduce_impl=impl,
                block_n=max(8, ctx.n_objects // max(1, n_parts)),
            )
            findings += audit_plan_steps(report, plan, backends=backends, device=device,
                                         batch=batch, label=f"{n_parts}x{cand_parts}/{impl}/")
    return findings


# ---------------------------------------------------------------------------
# query-engine batch steps + rules/basis device passes
# ---------------------------------------------------------------------------


def _tiny_store(n_parts: int, impl: str, device="cpu"):
    """A real ConceptStore over a brute-force-mined 8-attribute context."""
    from repro_torch.core.context import FormalContext
    from repro_torch.dist.shardplan import ShardPlan
    from repro_torch.query.store import ConceptStore

    rng = np.random.default_rng(11)
    n_attrs, n_objects = 8, 20
    dense = rng.integers(0, 2, size=(n_objects, n_attrs), dtype=np.uint8)
    rows = np.zeros((n_objects, 1), np.uint32)
    for a in range(n_attrs):
        rows[:, 0] |= dense[:, a].astype(np.uint32) << a
    ctx = FormalContext(
        rows=rows, n_objects=n_objects, n_attrs=n_attrs, attr_names=None
    )
    # brute-force intents: closure of every attribute subset
    intents = set()
    for m in range(1 << n_attrs):
        have = (rows[:, 0] & np.uint32(m)) == np.uint32(m)
        intent = np.uint32((1 << n_attrs) - 1)
        for r in rows[have, 0]:
            intent &= r
        intents.add(int(intent) if have.any() else (1 << n_attrs) - 1)
    intents = np.array(sorted(intents), np.uint32)[:, None]
    plan = ShardPlan.simulated(n_parts, reduce_impl=impl, block_n=8)
    return ConceptStore.build(ctx, intents, plan=plan, device=device)


def audit_query_steps(report, *, n_parts_list=(1, 4), impls=IMPLS, backends=BACKENDS,
                      device=None) -> list[Finding]:
    """The QueryEngine's micro-batch steps: closure and top-k (one
    AND-allreduce round each), extents (one membership gather), rules (a
    replicated-table pass: no collective)."""
    from repro_torch.device import device_bits
    from repro_torch.query.engine import QueryConfig, QueryEngine

    findings = []
    for n_parts in n_parts_list:
        for impl in impls:
            store = _tiny_store(n_parts, impl, device)
            st = store.state
            snap, plan, dev = st.snapshot, store.plan, store.device
            rng = np.random.default_rng(5)
            for backend in backends:
                qe = QueryEngine(store, QueryConfig(backend=backend))
                S, W = qe.cfg.slots, qe.W
                cands = device_bits(
                    rng.integers(0, 1 << qe.n_attrs, size=(S, W), dtype=np.uint32), dev)
                pfx = f"{n_parts}x1/{impl}/{backend}/query/"
                cases = (
                    ("closure", qe._closure_step(impl, snap.probe),
                     (st.rows, cands, st.n_pad, snap.intents, snap.skeys, snap.n_concepts)),
                    ("topk", qe._topk_step(impl, 5),
                     (st.rows, cands, st.n_pad, snap.intents, snap.supports, snap.n_concepts)),
                )
                for kind, step, args in cases:
                    findings += audit_call(
                        pfx + kind, step, args, plan=plan, W=W, device=dev, impl=impl,
                        expected_bytes=plan.modeled_reduce_bytes(S, W, qe.n_attrs))
                    report.note_checked("spmd", "query_steps")
                # extents: the membership gather IS the modeled payload —
                # [Nl, S] words per shard, one ring, k·(k-1)·Nl·S·4
                ids = torch.from_numpy(rng.integers(0, snap.cap, size=S)).to(dev).long()
                n_local = st.N_padded // n_parts
                findings += audit_call(
                    pfx + "extents", qe._extents_step(), (snap.ext_cols, ids), plan=plan,
                    W=W, device=dev, impl=impl, expect_obj_pattern=False,
                    expected_bytes=n_parts * (n_parts - 1) * n_local * S * 4)
                report.note_checked("spmd", "query_steps")
                # rules: replicated-table compute — a collective here would
                # break snapshot consistency
                R = 8
                rules_args = (
                    device_bits(rng.integers(0, 1 << qe.n_attrs, size=(R, W), dtype=np.uint32)
                                & np.uint32(0x0F), dev),
                    device_bits(rng.integers(0, 1 << qe.n_attrs, size=(R, W), dtype=np.uint32),
                                dev),
                    torch.from_numpy(rng.random(R).astype(np.float32)).to(dev),
                    torch.from_numpy(rng.random(R).astype(np.float32)).to(dev),
                    torch.arange(R, dtype=torch.int32, device=dev),
                    R, cands, np.float32(0.25),
                )
                findings += audit_call(pfx + "rules", qe._rules_step(5), rules_args, plan=plan,
                                       W=W, device=dev, replicated=True)
                report.note_checked("spmd", "query_steps")
    return findings


def audit_basis_passes(report, device=None) -> list[Finding]:
    """The rules/basis extraction device passes are replicated-table
    compute: no collective and no host read may sneak in.  (``lclosure``
    tests its fixpoint on the host once per pass by design, with
    ``torch.equal``, between passes; it runs without the sync guard.)"""
    from repro_torch.device import resolve_device
    from repro_torch.dist.shardplan import ShardPlan
    from repro_torch.rules import basis as basis_mod

    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    C, W = 8, 1

    def words(*shape):
        return torch.from_numpy(
            rng.integers(0, 256, size=shape, dtype=np.uint32).view(np.int32)).to(dev)

    X, fam, added = words(4, W), words(C, W), words(C, W)
    sup = torch.from_numpy(rng.integers(1, 20, size=C).astype(np.int32)).to(dev)
    mask = torch.full((W,), 0xFF, dtype=torch.int32, device=dev)
    targets = (
        ("family_closure", basis_mod.family_closure, (X, fam, 6, mask)),
        ("family_support", basis_mod.family_support, (X, fam, sup, 6)),
        ("lclosure", basis_mod.lclosure, (X, fam, added, 6)),
    )
    findings = []
    for name, fn, args in targets:
        findings += audit_call(f"basis/{name}", fn, args, plan=ShardPlan.simulated(1), W=W,
                               device=dev, replicated=True, guard=False)
        report.note_checked("spmd", "basis_passes")
    return findings


def run(report, *, quick: bool = False, device=None) -> list[Finding]:
    """Full Pass-1 sweep, on the card when one is present (else the CPU);
    ``quick`` restricts to one geometry per shape class (smoke runs, not
    the strict gate)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    geoms = ((1, 1), (2, 4)) if quick else GEOMETRIES
    findings = self_test(device)
    report.note_checked("spmd", "self_tests")
    findings += audit_frontier_steps(report, geometries=geoms, device=device)
    findings += audit_query_steps(
        report, n_parts_list=(2,) if quick else (1, 4), device=device
    )
    findings += audit_basis_passes(report, device=device)
    return findings
