"""Open-loop load generator — sustained-QPS serving measurement.

The port's counterpart of the reference's ``serve/loadgen.py``: the same
arrival processes and workload mix, drawn from the caller's numpy
``Generator`` in the same order (the same seed gives equal arrival arrays
and equal ``(kind, payload)`` events in both packages), and the same
open-loop driver over :class:`repro_torch.serve.AdmissionQueue`:

* **Arrival processes** — :func:`poisson_arrivals` (exponential gaps at
  a target QPS) and :func:`burst_arrivals` (a square-wave–modulated
  Poisson process: ``factor``× the base rate during the duty window,
  renormalized so the mean offered rate stays the target — the
  worst-case pattern for a deadline-or-full batcher).
* **Workload mix** — :func:`make_workload` draws a per-arrival kind from
  a weighted mix of ``closure`` / ``topk`` / ``lookup`` / ``rules``
  queries (payloads sampled to hit populated lattice regions) and
  ``update`` events (streamed object batches through
  ``StreamUpdater.stage`` + ``commit`` — snapshot swaps land *between*
  micro-batches while queries keep serving).
* **Open loop** — :func:`run_load` submits each request at its scheduled
  time regardless of how the server is doing.  When the host falls
  behind, arrivals are submitted late with their arrival time backdated
  to the schedule, so queueing delay is charged to the measured latency
  (no coordinated omission) and the bounded queue sheds exactly as it
  would under real overload.

The measurement is wall-clock by default but fully clock-injectable:
tests drive a virtual clock through the same code path a timed run takes.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import bitset
from repro_torch.obs import slo as slo_mod
from repro_torch.obs import trace as obs
from repro_torch.serve.admission import AdmissionQueue

QUERY_KINDS = ("closure", "topk", "lookup", "rules")
DEFAULT_MIX = {"closure": 0.6, "topk": 0.3, "lookup": 0.1}


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------


def poisson_arrivals(qps: float, duration_s: float, rng) -> np.ndarray:
    """Sorted arrival offsets (seconds) of a Poisson process at ``qps``
    over ``duration_s`` — exponential inter-arrival gaps."""
    if qps <= 0 or duration_s <= 0:
        return np.zeros((0,), np.float64)
    n_est = int(qps * duration_s * 1.5) + 16
    gaps = rng.exponential(1.0 / qps, size=n_est)
    times = np.cumsum(gaps)
    while times.size and times[-1] < duration_s:  # tail top-up (rare)
        more = np.cumsum(rng.exponential(1.0 / qps, size=n_est)) + times[-1]
        times = np.concatenate([times, more])
    return times[times < duration_s]


def burst_arrivals(
    qps: float,
    duration_s: float,
    rng,
    *,
    period_s: float = 1.0,
    duty: float = 0.25,
    factor: float = 4.0,
) -> np.ndarray:
    """Bursty arrivals: a Poisson process whose rate alternates between
    ``hi`` (for ``duty`` of each period) and ``lo``, with the mean held
    at ``qps`` (``duty·hi + (1-duty)·lo = qps``, ``hi = factor·lo``).
    ``factor ≥ 1``; ``factor=1`` degenerates to plain Poisson."""
    if factor < 1.0:
        raise ValueError("burst factor must be ≥ 1")
    lo = qps / (duty * factor + (1.0 - duty))
    hi = factor * lo
    # thinning: draw at the peak rate, keep with p = rate(t)/hi
    cand = poisson_arrivals(hi, duration_s, rng)
    phase = (cand / period_s) % 1.0
    rate = np.where(phase < duty, hi, lo)
    keep = rng.random(cand.size) < rate / hi
    return cand[keep]


ARRIVALS = {"poisson": poisson_arrivals, "burst": burst_arrivals}


# ---------------------------------------------------------------------------
# workload mix
# ---------------------------------------------------------------------------


def make_workload(
    ctx,
    n: int,
    rng,
    *,
    mix: dict[str, float] | None = None,
    update_rows: int = 2,
    density: float | None = None,
) -> list[tuple[str, np.ndarray]]:
    """``n`` ``(kind, payload)`` events drawn from the weighted ``mix``.

    Query payloads are thinned real context rows (~25% of bits kept — the
    same populated-region sampling every serving bench uses); ``update``
    payloads are ``update_rows`` synthetic objects at the context's
    density.  ``lookup`` uses raw thinned rows, so cache misses (a
    legitimate part of real traffic) are measured alongside hits.
    """
    mix = dict(mix or DEFAULT_MIX)
    bad = set(mix) - set(QUERY_KINDS) - {"update"}
    if bad:
        raise ValueError(f"unknown workload kinds {sorted(bad)}")
    kinds = sorted(mix)
    weights = np.array([mix[k] for k in kinds], np.float64)
    if weights.sum() <= 0:
        raise ValueError("workload mix weights must sum > 0")
    weights /= weights.sum()
    draws = rng.choice(len(kinds), size=n, p=weights)
    base = ctx.rows[rng.integers(0, ctx.n_objects, size=n)]
    keep = bitset.pack_bool(rng.random((n, ctx.n_attrs)) < 0.25, ctx.W)
    queries = base & keep
    dens = 0.3 if density is None else max(0.05, density)
    events = []
    for i, d in enumerate(draws):
        kind = kinds[d]
        if kind == "update":
            rows = bitset.pack_bool(
                rng.random((update_rows, ctx.n_attrs)) < dens, ctx.W
            )
            events.append((kind, rows))
        else:
            events.append((kind, queries[i]))
    return events


# ---------------------------------------------------------------------------
# the open-loop driver
# ---------------------------------------------------------------------------


@dataclass
class LoadReport:
    """One sustained-load measurement, JSON-ready via ``describe()``."""

    offered_qps: float
    duration_s: float
    wall_s: float
    submitted: int = 0
    admitted: int = 0
    shed: int = 0
    completed: int = 0
    achieved_qps: float = 0.0
    e2e: dict = field(default_factory=dict)
    admission_wait: dict = field(default_factory=dict)
    occupancy_mean: float = 0.0
    dispatches: int = 0
    dispatch_causes: dict = field(default_factory=dict)
    by_kind: dict = field(default_factory=dict)
    updates: int = 0
    update_latency: dict = field(default_factory=dict)
    max_lag_s: float = 0.0  # worst (now - scheduled arrival) at submit
    slo: dict = field(default_factory=dict)

    @property
    def shed_rate(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    def describe(self) -> dict:
        d = dataclasses.asdict(self)
        d["shed_rate"] = round(self.shed_rate, 6)
        return d


def run_load(
    queue: AdmissionQueue,
    arrivals: np.ndarray,
    events: list[tuple[str, np.ndarray]],
    *,
    updater=None,
    clock=time.monotonic,
    sleep=time.sleep,
    slo=None,
) -> LoadReport:
    """Drive ``events`` through ``queue`` at their scheduled ``arrivals``.

    Single-threaded and open-loop: each pass submits every arrival whose
    time has come (backdating ``arrival_s`` to the schedule), polls the
    queue for due deadlines, then sleeps to the next event edge.  While
    a dispatch blocks on the engine, time keeps passing — the next pass
    submits the backlog late, exactly like a saturated server.  Ends
    with a :meth:`~AdmissionQueue.flush`.

    ``update`` events call ``updater.stage``+``commit`` inline (snapshot
    swap between micro-batches); with no ``updater`` they are skipped
    and not counted as offered queries.  With ``slo`` (an
    :class:`repro_torch.obs.slo.SLO`), the report gains an SLO evaluation.
    """
    if len(arrivals) != len(events):
        raise ValueError("one arrival time per event")
    duration = float(arrivals[-1]) if len(arrivals) else 0.0
    rep = LoadReport(
        offered_qps=len(arrivals) / duration if duration else 0.0,
        duration_s=duration,
        wall_s=0.0,
    )
    st = queue.stats
    base = (st.submitted, st.admitted, st.shed, st.completed, st.dispatches)
    t0 = clock()
    i = 0
    with obs.current().span(
        "serve/load", offered=len(arrivals), duration_s=round(duration, 3)
    ):
        while i < len(arrivals):
            now = clock() - t0
            while i < len(arrivals) and arrivals[i] <= now:
                kind, payload = events[i]
                sched = float(arrivals[i])
                rep.max_lag_s = max(rep.max_lag_s, now - sched)
                if kind == "update":
                    if updater is not None:
                        tu = clock()
                        receipt = updater.stage(payload)
                        updater.commit()
                        queue.registry.observe(
                            "serve_update_commit_s", clock() - tu
                        )
                        queue.registry.gauge(
                            "serve_snapshot_version", receipt.version
                        )
                        rep.updates += 1
                else:
                    queue.submit(kind, payload, arrival_s=t0 + sched)
                i += 1
            queue.poll()
            if i < len(arrivals):
                now = clock() - t0
                wait = min(
                    arrivals[i] - now,
                    queue.next_deadline_in(clock()),
                )
                if arrivals[i] > now:
                    # floor the sleep: next_deadline_in computes
                    # (t + max_wait) - now while poll tests
                    # now - t >= max_wait, and the two round differently,
                    # so wait can be a positive ~1e-17 whose sleep never
                    # advances an injected virtual clock (livelock) and
                    # busy-spins a real one.  The same rounding gives a
                    # wait of 0 or less for a deadline poll does not yet
                    # find due, so the sleep is floored there too, and
                    # skipped only for an arrival already due.
                    sleep(min(max(wait, 1e-5), 0.002))
        queue.poll()
        queue.flush()
    rep.wall_s = clock() - t0

    # -- roll the queue's ledgers into the report --------------------------
    rep.submitted = st.submitted - base[0]
    rep.admitted = st.admitted - base[1]
    rep.shed = st.shed - base[2]
    rep.completed = st.completed - base[3]
    rep.dispatches = st.dispatches - base[4]
    rep.dispatch_causes = dict(st.dispatch_causes)
    rep.occupancy_mean = round(st.occupancy_mean, 4)
    rep.by_kind = dict(st.by_kind)
    rep.achieved_qps = (
        round(rep.completed / rep.wall_s, 1) if rep.wall_s > 0 else 0.0
    )
    rep.e2e = _hist_view(st, "e2e")
    rep.admission_wait = _hist_view(st, "admission_wait")
    if rep.updates:
        uh = queue.registry.histogram("serve_update_commit_s")
        rep.update_latency = {
            "count": uh.count,
            **{k: round(v, 6) for k, v in uh.percentiles().items()},
        }
    if slo is not None:
        e2e_h = st.registry.histogram("latency_s", kind="e2e")
        rep.slo = slo_mod.evaluate(
            slo,
            compliance=e2e_h.fraction_below(slo.latency_objective_s),
            shed_rate=rep.shed_rate,
            p99_s=rep.e2e.get("p99"),
        )
    return rep


def _hist_view(st, kind: str) -> dict:
    h = st.registry.histogram("latency_s", kind=kind)
    if h.count == 0:
        return {}
    return {
        "count": h.count,
        "mean": round(h.sum / h.count, 6),
        "max": round(h.max, 6),
        **{k: round(v, 6) for k, v in h.percentiles().items()},
    }
