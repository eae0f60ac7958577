"""Pass 3b — deterministic schedule-fuzzing harness for the serve tier.

The static lock checker cannot see races that flow through aliases or
snapshot references, so this harness *runs* the real
:class:`repro_torch.serve.admission.AdmissionQueue` against a scripted
double-buffered store under a *virtual clock* and a seeded random
interleaving of ``submit`` / ``poll`` / ``advance`` / ``stage`` /
``commit`` operations, then checks happens-before invariants on the
snapshot versions every dispatched micro-batch observed:

* **monotone reads** — observed snapshot versions never go backwards
  (each batch reads ONE consistent ``store.state`` at entry; a batch
  observing an older version than a previous batch means a torn read);
* **committed floor** — a batch dispatched after ``commit()`` returned
  must observe at least that committed version (no stale-snapshot
  resurrection);
* **conservation** — after ``flush()``: nothing pending, every admitted
  ticket carries a result, shed + completed == submitted, and every
  ticket's virtual dispatch time ≥ its arrival time.

Determinism: one thread, one ``random.Random(seed)``, a virtual clock
that only moves on explicit ``advance`` ops — the same seed replays the
same schedule bit-for-bit (the CI gate runs a fixed seed set), and it is
the JAX package's schedule for that seed, draw for draw: the draws, their
weights and their order are the reference harness's.

``inject_race=True`` swaps in a store whose ``commit`` *publishes a
stale snapshot* (the staged version is dropped on the floor) — the
defect the double-buffer discipline exists to prevent.  The harness must
flag it; that self-test is how we know the invariants have teeth.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

from repro_torch.analysis.findings import Finding


class VirtualClock:
    """Injectable monotone clock; advances only when the schedule says so."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += dt
        return self.now


@dataclasses.dataclass(frozen=True)
class _Snapshot:
    version: int


@dataclasses.dataclass(frozen=True)
class _State:
    snapshot: _Snapshot


class ScriptedStore:
    """Double-buffered snapshot store with the ConceptStore discipline:
    ``state`` is one immutable reference, ``stage`` prepares a successor,
    ``commit`` swaps it in.  ``inject_race=True`` breaks the swap —
    commit discards the staged version and republishes a *stale* one."""

    def __init__(self, *, inject_race: bool = False):
        self.state = _State(_Snapshot(version=0))
        self._staged: _State | None = None
        self.committed_version = 0
        self.inject_race = inject_race

    def stage(self):
        self._staged = _State(_Snapshot(self.state.snapshot.version + 1))

    def commit(self) -> int:
        if self._staged is None:
            return self.committed_version
        staged = self._staged
        self._staged = None
        if self.inject_race:
            # the bug under test: the swap publishes an old snapshot while
            # the committed floor moves forward
            self.state = _State(_Snapshot(max(0, staged.snapshot.version - 2)))
        else:
            self.state = staged
        self.committed_version = staged.snapshot.version
        return self.committed_version


class ProbeEngine:
    """Stub query engine for the admission queue: every batch records the
    snapshot version it observed and the committed floor at dispatch —
    the happens-before evidence the invariants run on."""

    def __init__(self, store: ScriptedStore, *, slots: int = 4):
        from repro_torch.obs import StatsBase

        self.store = store
        self.cfg = dataclasses.make_dataclass("Cfg", ["slots"])(slots)
        self.stats = StatsBase()
        self.observations: list[tuple[int, int]] = []  # (observed, floor)

    def _observe(self, n: int):
        state = self.store.state  # ONE consistent read per micro-batch
        self.observations.append(
            (state.snapshot.version, self.store.committed_version)
        )
        return state.snapshot.version, n

    def closure_batch(self, arr):
        v, n = self._observe(arr.shape[0])
        return arr, np.full(n, v), np.arange(n)

    def topk_batch(self, arr, k=5):
        v, n = self._observe(arr.shape[0])
        return np.full((n, k), v), np.zeros((n, k))

    def lookup_batch(self, arr):
        v, n = self._observe(arr.shape[0])
        return np.full(n, v)

    def rules_batch(self, index, arr, k=5, min_conf=0.0, rank_by="confidence"):
        v, n = self._observe(arr.shape[0])
        return np.full((n, k), v), np.zeros((n, k)), arr


OPS = ("submit", "poll", "advance", "stage", "commit")


def run_schedule(
    seed: int,
    *,
    steps: int = 200,
    slots: int = 4,
    inject_race: bool = False,
) -> list[Finding]:
    """One fuzzed schedule; returns invariant violations as findings."""
    from repro_torch.serve.admission import AdmissionConfig, AdmissionQueue

    rng = random.Random(seed)
    clock = VirtualClock()
    store = ScriptedStore(inject_race=inject_race)
    engine = ProbeEngine(store, slots=slots)
    queue = AdmissionQueue(
        engine,
        AdmissionConfig(max_wait_s=0.004, depth=16),
        clock=clock,
    )
    label = f"seed={seed}/race={'on' if inject_race else 'off'}"
    findings = []
    tickets = []
    kinds = ("closure", "topk", "lookup")
    for _ in range(steps):
        op = rng.choices(OPS, weights=(6, 3, 3, 2, 2))[0]
        if op == "submit":
            payload = np.full(1, rng.randrange(256), np.uint32)
            tickets.append(queue.submit(rng.choice(kinds), payload))
        elif op == "poll":
            queue.poll()
        elif op == "advance":
            clock.advance(rng.choice((0.001, 0.002, 0.005)))
        elif op == "stage":
            store.stage()
        else:
            store.commit()
    queue.flush()

    def err(rule, msg):
        findings.append(Finding("fuzz", rule, label, msg))

    prev = -1
    for i, (observed, floor) in enumerate(engine.observations):
        if observed < prev:
            err(
                "nonmonotone-snapshot",
                f"batch {i} observed snapshot v{observed} after an earlier "
                f"batch observed v{prev} — torn/stale snapshot read",
            )
        if observed < floor:
            err(
                "stale-after-commit",
                f"batch {i} observed snapshot v{observed} but v{floor} had "
                "already committed (happens-before violation)",
            )
        prev = max(prev, observed)

    if queue.pending():
        err("unflushed-tickets", f"{queue.pending()} tickets stuck after flush")
    for i, t in enumerate(tickets):
        if t.shed:
            continue
        if t.result is None or t.done_s is None:
            err("lost-ticket", f"admitted ticket {i} never dispatched")
        elif t.dispatch_s < t.arrival_s:
            err(
                "time-travel",
                f"ticket {i} dispatched at {t.dispatch_s} before its "
                f"arrival {t.arrival_s}",
            )
    st = queue.stats
    if st.shed + st.completed != st.submitted:
        err(
            "ticket-conservation",
            f"shed({st.shed}) + completed({st.completed}) != "
            f"submitted({st.submitted})",
        )
    return findings


DEFAULT_SEEDS = tuple(range(8))


def run(report, *, seeds=DEFAULT_SEEDS, steps: int = 200) -> list[Finding]:
    """Clean-schedule sweep (must be silent) plus the injected-race
    self-test (must fire) — a harness that cannot detect the seeded bug
    is itself reported."""
    findings = []
    for seed in seeds:
        findings.extend(run_schedule(seed, steps=steps))
        report.note_checked("fuzz", "schedules")
    injected = run_schedule(seeds[0], steps=steps, inject_race=True)
    report.note_checked("fuzz", "injected")
    if not any(
        f.rule in ("stale-after-commit", "nonmonotone-snapshot")
        for f in injected
    ):
        findings.append(
            Finding(
                "fuzz",
                "harness-blind",
                f"seed={seeds[0]}/race=on",
                "injected stale-snapshot commit produced no violation — "
                "the fuzz invariants lost their teeth",
            )
        )
    return findings
