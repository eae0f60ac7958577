"""Continuous admission queue — asynchronous arrivals packed into the
port's ``QueryEngine`` fixed-slot micro-batches.

The port's counterpart of the reference's ``serve/admission.py``, over
:class:`repro_torch.query.QueryEngine`.  Requests arrive one at a time
(:meth:`AdmissionQueue.submit`), join a bounded per-kind queue, and
dispatch as ONE engine micro-batch when either trigger fires:

* **full** — a kind has :attr:`~AdmissionQueue.slots` waiting requests:
  dispatch at once, inline in ``submit`` (the batch is exactly one padded
  round, so a full batch never waits on the deadline);
* **deadline** — the oldest waiting request has aged
  :attr:`~AdmissionConfig.max_wait_s`: dispatch the partial batch
  (:meth:`poll`), trading slot occupancy for bounded queueing delay;
* **flush** — :meth:`flush` drains everything (end of a load run,
  shutdown).

Admission is *bounded*: a kind whose queue already holds
:attr:`~AdmissionConfig.depth` requests sheds new arrivals at submit time
(ticket marked, ``serve_shed_total`` counted) — under overload the queue
degrades by rejecting, never by growing without limit.

Results are **bit-identical to pre-formed batches**: a dispatch slices at
most ``slots`` tickets and hands their rows to the very batch entry points
a pre-formed batch calls — ``closure_batch`` (K1 on ``backend="kernel"``),
``topk_batch`` (K1, then K5), ``lookup_batch`` (torch) and
``rules_batch`` (K6).  Each micro-batch is a pure function of (snapshot,
rows), so any grouping of the same queries gives the same per-query
answers.  Snapshot swaps (``StreamUpdater.commit``) interleave safely:
every engine batch reads one consistent ``store.state`` at entry.
Payloads and results stay numpy at the queue boundary; a ticket holds no
tensor.  A failed launch inside a dispatch raises through ``submit`` /
``poll`` / ``flush``; nothing answers it with a plain version.

Telemetry rides the engine's own registry (one exporter snapshot covers
queue and engine): ``serve_queue_depth`` gauges, the
``serve_slot_occupancy`` histogram, ``serve_submitted_total`` /
``serve_shed_total`` / ``serve_dispatch_total`` counters,
``serve_admission_wait_s`` / ``serve_e2e_s`` histograms, and a
``serve/dispatch`` span per micro-batch on the current tracer.  The
dataclass view (:class:`ServeStats`) rides ``dataclasses.asdict`` into
the CLI JSON like every other stats tier.

Threading: :meth:`submit` is thread-safe; dispatches serialize on one
lock (the engine's stats are not thread-safe).  A background dispatcher
thread (:meth:`start` / :meth:`stop`) drives deadlines for live serving;
on one card it launches on the default stream like every other thread.
An exception inside it ends the thread and is raised again by
:meth:`stop`.  The open-loop load generator drives :meth:`poll` itself
for deterministic measurement.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs import StatsBase
from repro_torch.obs import trace as obs

# Queue-servable query kinds (updates go to StreamUpdater — a commit is a
# single-flight snapshot swap, not a slot-packable request).
KINDS = ("closure", "topk", "lookup", "rules")


@dataclass
class AdmissionConfig:
    max_wait_s: float = 0.002  # deadline: oldest ticket age before dispatch
    depth: int = 512  # per-kind pending bound; beyond it, shed
    topk_k: int = 5  # k for "topk" dispatches
    rules_k: int = 5  # top-k rules per "rules" query
    rules_min_conf: float = 0.0
    rules_rank_by: str = "confidence"


@dataclass
class ServeStats(StatsBase):
    """Admission-side stats; latency percentiles (``admission_wait``,
    ``e2e``) inherit from :class:`repro_torch.obs.StatsBase`."""

    submitted: int = 0
    admitted: int = 0
    shed: int = 0
    completed: int = 0
    dispatches: int = 0
    dispatch_causes: dict = field(default_factory=dict)
    occupancy_sum: float = 0.0
    by_kind: dict = field(default_factory=dict)

    @property
    def shed_rate(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    @property
    def occupancy_mean(self) -> float:
        return self.occupancy_sum / self.dispatches if self.dispatches else 0.0


class Ticket:
    """One admitted (or shed) request.

    ``result`` is the per-query row of the engine batch output (a tuple
    of numpy arrays for closure/topk/rules, a numpy scalar id for lookup);
    ``None`` until dispatched, forever ``None`` when ``shed``.
    ``arrival_s`` is the *offered* arrival time — the open-loop load
    generator backdates it to the scheduled arrival, so queueing delay
    accrued while the host was busy is charged to the latency, not
    silently omitted (coordinated-omission-free measurement).
    """

    __slots__ = (
        "kind", "payload", "arrival_s", "shed", "dispatch_s", "done_s",
        "result",
    )

    def __init__(self, kind: str, payload, arrival_s: float):
        self.kind = kind
        self.payload = payload
        self.arrival_s = arrival_s
        self.shed = False
        self.dispatch_s: float | None = None
        self.done_s: float | None = None
        self.result = None

    @property
    def done(self) -> bool:
        return self.shed or self.done_s is not None

    @property
    def e2e_s(self) -> float | None:
        return None if self.done_s is None else self.done_s - self.arrival_s


class AdmissionQueue:
    def __init__(
        self,
        engine,
        cfg: AdmissionConfig | None = None,
        *,
        rules_index=None,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.cfg = cfg or AdmissionConfig()
        self.rules_index = rules_index
        self.clock = clock
        self.slots = engine.cfg.slots
        self.stats = ServeStats()
        # one registry across queue + engine: a single /metrics snapshot
        # carries queue depth AND the engine's schedule census
        self.registry = engine.stats.registry
        self._queues: dict[str, deque[Ticket]] = {k: deque() for k in KINDS}
        self._lock = threading.Lock()  # guards queues + admission counters
        self._dispatch_lock = threading.Lock()  # serializes engine batches
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._thread_error: Exception | None = None

    # -- admission -----------------------------------------------------------

    def submit(self, kind: str, payload, *, arrival_s: float | None = None) -> Ticket:
        """Admit one request (thread-safe); returns its ticket.

        Sheds (ticket.shed, result stays None) when the kind's queue is
        at ``depth``.  A submission that fills a batch dispatches it
        inline — "full" never waits for the poller.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; choose {KINDS}")
        if kind == "rules" and self.rules_index is None:
            raise ValueError("rules queries need an AdmissionQueue rules_index")
        now = self.clock()
        ticket = Ticket(kind, payload, now if arrival_s is None else arrival_s)
        st = self.stats
        with self._lock:
            q = self._queues[kind]
            st.submitted += 1
            st.by_kind[kind] = st.by_kind.get(kind, 0) + 1
            self.registry.counter("serve_submitted_total", kind=kind)
            if len(q) >= self.cfg.depth:
                ticket.shed = True
                st.shed += 1
                self.registry.counter("serve_shed_total", kind=kind)
                return ticket
            st.admitted += 1
            q.append(ticket)
            depth = len(q)
            full = depth >= self.slots
            self.registry.gauge("serve_queue_depth", depth, kind=kind)
        if full:
            self._dispatch(kind, "full")
        return ticket

    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def next_deadline_in(self, now: float | None = None) -> float:
        """Seconds until the oldest waiting ticket's deadline fires
        (may be ≤ 0 when already due); +inf when idle."""
        now = self.clock() if now is None else now
        with self._lock:
            oldest = [q[0].arrival_s for q in self._queues.values() if q]
        if not oldest:
            return float("inf")
        return min(t + self.cfg.max_wait_s - now for t in oldest)

    # -- dispatch ------------------------------------------------------------

    def poll(self, now: float | None = None) -> int:
        """Dispatch every kind whose deadline has fired or whose queue
        filled between polls.  Returns the number of batches dispatched."""
        now = self.clock() if now is None else now
        n = 0
        for kind in KINDS:
            while True:
                with self._lock:
                    q = self._queues[kind]
                    if not q:
                        break
                    full = len(q) >= self.slots
                    due = now - q[0].arrival_s >= self.cfg.max_wait_s
                if full:
                    n += self._dispatch(kind, "full")
                elif due:
                    n += self._dispatch(kind, "deadline")
                    break  # partial batch drained the queue for this kind
                else:
                    break
        return n

    def flush(self) -> int:
        """Dispatch everything pending regardless of deadlines (end of a
        load run / shutdown drain).  Returns batches dispatched."""
        n = 0
        while self.pending():
            for kind in KINDS:
                while True:
                    with self._lock:
                        empty = not self._queues[kind]
                    if empty:
                        break
                    n += self._dispatch(kind, "flush")
        return n

    def _take(self, kind: str) -> list[Ticket]:
        with self._lock:
            q = self._queues[kind]
            batch = [q.popleft() for _ in range(min(self.slots, len(q)))]
            self.registry.gauge("serve_queue_depth", len(q), kind=kind)
        return batch

    def _dispatch(self, kind: str, cause: str) -> int:
        with self._dispatch_lock:
            batch = self._take(kind)
            if not batch:
                return 0
            t_dispatch = self.clock()
            occupancy = len(batch) / self.slots
            with obs.current().span(
                "serve/dispatch", kind=kind, cause=cause, n=len(batch),
                occupancy=round(occupancy, 4),
            ):
                results = self._run(kind, batch)
            t_done = self.clock()
        st = self.stats
        reg = self.registry
        reg.observe("serve_slot_occupancy", occupancy)
        reg.counter("serve_dispatch_total", kind=kind, cause=cause)
        with self._lock:
            st.dispatches += 1
            st.dispatch_causes[cause] = st.dispatch_causes.get(cause, 0) + 1
            st.occupancy_sum += occupancy
            st.completed += len(batch)
        for ticket, result in zip(batch, results):
            ticket.dispatch_s = t_dispatch
            ticket.done_s = t_done
            ticket.result = result
            wait = t_dispatch - ticket.arrival_s
            e2e = t_done - ticket.arrival_s
            reg.observe("serve_admission_wait_s", wait, kind=kind)
            reg.observe("serve_e2e_s", e2e, kind=kind)
            st.observe_latency("admission_wait", wait)
            st.observe_latency("e2e", e2e)
        return 1

    def _run(self, kind: str, batch: list[Ticket]) -> list:
        """One engine micro-batch for ≤ slots tickets → per-ticket rows.
        The same batch entry points a pre-formed batch calls — the
        bit-identity guarantee lives here."""
        qe, cfg = self.engine, self.cfg
        arr = np.stack([t.payload for t in batch])
        if kind == "closure":
            closures, supports, ids = qe.closure_batch(arr)
            return list(zip(closures, supports, ids))
        if kind == "topk":
            ids, vals = qe.topk_batch(arr, k=cfg.topk_k)
            return list(zip(ids, vals))
        if kind == "lookup":
            return list(qe.lookup_batch(arr))
        ids, scores, cons = qe.rules_batch(
            self.rules_index, arr, k=cfg.rules_k,
            min_conf=cfg.rules_min_conf, rank_by=cfg.rules_rank_by,
        )
        return list(zip(ids, scores, cons))

    # -- background dispatcher (live serving) --------------------------------

    def start(self, idle_sleep_s: float = 0.0005) -> None:
        """Run a daemon dispatcher thread that fires deadlines."""
        if self._thread is not None:
            raise RuntimeError("dispatcher already running")
        self._stop.clear()
        self._thread_error = None

        def loop():
            try:
                while not self._stop.is_set():
                    self.poll()
                    wait = self.next_deadline_in()
                    if wait == float("inf"):
                        wait = idle_sleep_s
                    if wait > 0:
                        self._stop.wait(min(wait, idle_sleep_s * 20))
            except Exception as e:  # kept for stop(), which raises it
                self._thread_error = e

        self._thread = threading.Thread(
            target=loop, daemon=True, name="repro-torch-admission"
        )
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatcher thread, then (``drain``) flush what is
        pending.  Raises ``RuntimeError`` if a dispatch failed inside the
        thread, or if the thread did not end within 10 s."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=10)
        alive = self._thread.is_alive()
        self._thread = None
        error, self._thread_error = self._thread_error, None
        if error is not None:
            raise RuntimeError("a dispatch in the dispatcher thread failed") from error
        if alive:
            raise RuntimeError("the dispatcher thread did not stop within 10 s")
        if drain:
            self.flush()

    def describe(self) -> dict:
        st = self.stats
        return {
            "slots": self.slots,
            "max_wait_s": self.cfg.max_wait_s,
            "depth": self.cfg.depth,
            "shed_rate": round(st.shed_rate, 6),
            "occupancy_mean": round(st.occupancy_mean, 4),
            "stats": dataclasses.asdict(st),
        }
