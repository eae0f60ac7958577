"""Metrics registry — counters, gauges, and log-bucketed histograms.

The port's counterpart of the reference's ``obs/metrics.py``, pure Python
and bucket for bucket the same, so percentiles read on one scale in both
packages.  A tiny label-aware :class:`Registry` (counters / gauges /
histograms) that ``EngineStats`` and ``QueryStats`` publish into, and an
HDR-style log-bucketed :class:`Histogram` whose p50/p95/p99 surface as
``latency_percentiles`` (per mining round, per query micro-batch).

The stats dataclasses stay the source of truth for scalar counters (call
sites mutate fields directly, ``st.h2d_transfers += 1``); each stats
object owns a private registry (non-field, created in ``__post_init__``
so ``dataclasses.asdict`` never sees it) holding the latency histograms,
and :meth:`StatsBase.publish` exports the scalar fields into the
registry for unified export.  The schedule census (``reduce_rounds`` /
``auto_hop_bytes`` / ``hop_calibrated``) lives once here as
:class:`ScheduleCensus`, so the autotuner's census is recorded
identically in the mining and serving tiers.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from dataclasses import dataclass, field

# ---------------------------------------------------------------------------
# HDR-style log-bucketed histogram
# ---------------------------------------------------------------------------

# Bucket boundaries grow geometrically by 2**(1/8) (~9% relative error per
# bucket) from a 1 µs floor — sparse dict storage, so an idle histogram
# costs one empty dict.
_FACTOR = 2.0 ** 0.125
_LOG_FACTOR = math.log(_FACTOR)
_VMIN = 1e-6


class Histogram:
    """Log-bucketed latency histogram with percentile readout.

    Values are seconds.  ``record`` is O(1); ``percentile`` walks the
    sorted buckets (tens of entries for realistic latency ranges).
    Relative quantile error is bounded by the bucket factor (~9%), the
    standard HDR trade: constant memory, no sample retention.

    The ~9% bound only holds *above* the 1 µs floor: observations below
    it land in the explicit underflow bucket (index 0, upper edge
    ``_VMIN``), are counted in ``count``/``sum``/percentile ranks as
    usual, and surface separately as :attr:`underflow` so a histogram
    dominated by sub-floor samples can't masquerade as a measured one.

    ``record`` is lock-protected: the serving tier observes latencies
    from dispatcher threads while the metrics endpoint snapshots — a
    bare ``count += 1`` would lose increments across threads.
    """

    __slots__ = ("buckets", "count", "sum", "min", "max", "_lock")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        v = max(float(value), 0.0)
        idx = 0 if v < _VMIN else int(math.log(v / _VMIN) / _LOG_FACTOR) + 1
        with self._lock:
            self.buckets[idx] = self.buckets.get(idx, 0) + 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def underflow(self) -> int:
        """Observations below the 1 µs floor (bucket 0) — reported
        explicitly so percentile error bounds stay honest."""
        return self.buckets.get(0, 0)  # lock: ok — one atomic dict read

    def _state(self):
        """Consistent ``(buckets, count, sum, min, max)`` snapshot.

        Readers must not walk ``self.buckets`` directly: dispatcher
        threads ``record`` concurrently, and a dict resize mid-iteration
        raises — and even without the raise, count/buckets would tear."""
        with self._lock:
            return dict(self.buckets), self.count, self.sum, self.min, self.max

    def fraction_below(self, threshold: float) -> float:
        """Fraction of observations whose bucket lies entirely at or
        below ``threshold`` seconds (conservative to one bucket's ~9%
        width) — the SLO compliance readout.  1.0 when empty."""
        with self._lock:
            if self.count == 0:
                return 1.0
            n = sum(
                c
                for idx, c in self.buckets.items()
                if _VMIN * _FACTOR**idx <= threshold
            )
            return n / self.count

    def bucket_edges(self) -> list[tuple[float, int]]:
        """Sorted ``(upper_edge_seconds, count)`` pairs of the populated
        buckets — the exporter's cumulative-bucket source."""
        with self._lock:
            return [
                (_VMIN * _FACTOR**idx, c)
                for idx, c in sorted(self.buckets.items())
            ]

    @staticmethod
    def _percentile_of(buckets, count, vmin, vmax, q: float) -> float:
        if count == 0:
            return 0.0
        rank = q / 100.0 * count
        seen = 0
        for idx in sorted(buckets):
            seen += buckets[idx]
            if seen >= rank:
                if idx == 0:
                    return min(_VMIN, vmax)
                # bucket upper edge, clamped to observed extrema
                upper = _VMIN * _FACTOR ** idx
                return max(vmin, min(upper, vmax))
        return vmax

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]); 0.0 when empty."""
        buckets, count, _, vmin, vmax = self._state()
        return self._percentile_of(buckets, count, vmin, vmax, q)

    def percentiles(self, qs=(50, 95, 99)) -> dict[str, float]:
        # one snapshot for the whole readout — p50/p95/p99 must agree on
        # the sample set even while records land concurrently
        buckets, count, _, vmin, vmax = self._state()
        return {
            f"p{q:g}": self._percentile_of(buckets, count, vmin, vmax, q)
            for q in qs
        }

    def summary(self) -> dict:
        buckets, count, total, vmin, vmax = self._state()
        return {
            "count": count,
            "sum": total,
            "min": 0.0 if count == 0 else vmin,
            "max": vmax,
            "underflow": buckets.get(0, 0),
            **{
                f"p{q:g}": self._percentile_of(buckets, count, vmin, vmax, q)
                for q in (50, 95, 99)
            },
        }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _key(name: str, labels: dict | None) -> tuple:
    return (name, tuple(sorted((labels or {}).items())))


# The label set every over-cap observation collapses into, plus the
# warning counter that records how many observations were rerouted per
# metric name.
OVERFLOW_LABELS = (("overflow", "true"),)
OVERFLOW_COUNTER = "labels_overflow_total"


class Registry:
    """Counters, gauges, and histograms with optional labels.

    One registry per stats object (mining engine, query engine) — no
    global mutable state, so two engines in one process never alias.

    Label cardinality is bounded: each metric name may carry at most
    ``max_label_sets`` distinct label combinations.  A labeled counter
    keyed on an unbounded value (query ids, client addresses) would
    otherwise grow the registry — and the exporter's scrape payload —
    without limit.  Observations past the cap collapse into one
    overflow series (labels ``{overflow="true"}``) and increment
    ``labels_overflow_total{metric=<name>}`` so the truncation is
    visible, never silent.

    Mutations and export take a lock: the serving tier's dispatcher
    records while the ``/metrics`` endpoint snapshots concurrently.
    """

    def __init__(self, max_label_sets: int = 64):
        self.max_label_sets = max_label_sets
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, Histogram] = {}
        self._label_sets: dict[str, set] = {}
        self._lock = threading.RLock()

    def _resolve(self, name: str, labels: dict) -> tuple:
        """The storage key for ``(name, labels)`` under the cardinality
        cap — callers must hold the lock."""
        k = _key(name, labels)
        if not k[1]:
            return k
        seen = self._label_sets.setdefault(name, set())
        if k[1] in seen:
            return k
        if len(seen) >= self.max_label_sets:
            wk = (OVERFLOW_COUNTER, (("metric", name),))
            self._counters[wk] = self._counters.get(wk, 0.0) + 1.0
            return (name, OVERFLOW_LABELS)
        seen.add(k[1])
        return k

    def counter(self, name: str, inc: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._resolve(name, labels)
            self._counters[k] = self._counters.get(k, 0.0) + inc

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[self._resolve(name, labels)] = float(value)

    def histogram(self, name: str, **labels) -> Histogram:
        with self._lock:
            k = self._resolve(name, labels)
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            return h

    def observe(self, name: str, value: float, **labels) -> None:
        self.histogram(name, **labels).record(value)

    @staticmethod
    def _fmt(k: tuple) -> str:
        name, labels = k
        if not labels:
            return name
        body = ",".join(f"{lk}={lv}" for lk, lv in labels)
        return f"{name}{{{body}}}"

    def export(self) -> dict:
        """Flat ``{metric{label=...}: value-or-summary}`` snapshot."""
        counters, gauges, hists = self._snapshot()
        out: dict = {}
        for k, v in counters:
            out[self._fmt(k)] = v
        for k, v in gauges:
            out[self._fmt(k)] = v
        for k, h in hists:
            out[self._fmt(k)] = h.summary()
        return out

    def _snapshot(self):
        with self._lock:
            return (
                sorted(self._counters.items()),
                sorted(self._gauges.items()),
                sorted(self._hists.items()),
            )

    def families(self) -> list[tuple[str, str, list]]:
        """Grouped ``(name, type, [(labels_tuple, value-or-Histogram)])``
        triples, names sorted — the OpenMetrics exporter's source view.
        A name used as two different types (never done by our call
        sites) exports each type under its own suffix-disambiguated
        family downstream; here they simply appear twice."""
        counters, gauges, hists = self._snapshot()
        fams: dict[tuple, list] = {}
        for (name, labels), v in counters:
            fams.setdefault((name, "counter"), []).append((labels, v))
        for (name, labels), v in gauges:
            fams.setdefault((name, "gauge"), []).append((labels, v))
        for (name, labels), h in hists:
            fams.setdefault((name, "histogram"), []).append((labels, h))
        return [
            (name, typ, series) for (name, typ), series in sorted(fams.items())
        ]


# ---------------------------------------------------------------------------
# shared stats base: schedule census + latency percentiles
# ---------------------------------------------------------------------------


@dataclass
class ScheduleCensus:
    """The autotuner's schedule census, shared by both stats tiers.

    ``reduce_rounds`` counts collective rounds by resolved reduce
    implementation (``allgather`` / ``rsag``); ``auto_hop_bytes`` and
    ``hop_calibrated`` record the wire-model calibration the `auto`
    resolver used.  Field order puts these first in subclass dataclasses
    — safe because every construction site passes keywords.
    """

    reduce_rounds: dict = field(default_factory=dict)
    auto_hop_bytes: int = 0
    hop_calibrated: bool = False

    def record_reduce(self, impl: str, n: int = 1) -> None:
        self.reduce_rounds[impl] = self.reduce_rounds.get(impl, 0) + n


@dataclass
class StatsBase(ScheduleCensus):
    """Census + latency view: dataclass fields stay the public API; the
    private registry (non-field — invisible to ``dataclasses.asdict``)
    holds the histograms behind ``latency_percentiles``."""

    # {kind: {p50, p95, p99}} in seconds — host wall times, never
    # compared between runs (the counters above are)
    latency_percentiles: dict[str, dict[str, float]] = field(default_factory=dict)

    def __post_init__(self):
        # object.__setattr__-free: plain attrs, excluded from asdict/fields
        self._registry = Registry()
        self._obs_lock = threading.Lock()

    @property
    def registry(self) -> Registry:
        reg = getattr(self, "_registry", None)
        if reg is None:  # copy.replace / __reduce__ paths skip __post_init__
            reg = self._registry = Registry()
        return reg

    def _latency_lock(self) -> threading.Lock:
        lock = getattr(self, "_obs_lock", None)
        if lock is None:  # same skipped-__post_init__ paths as registry
            lock = self._obs_lock = threading.Lock()
        return lock

    def observe_latency(self, kind: str, seconds: float) -> None:
        """Record one latency sample and refresh the percentile view.

        ``latency_percentiles[kind]`` is a real dict field so it rides
        ``dataclasses.asdict`` into every stats JSON for free.  The view
        is replaced copy-on-write under ``_obs_lock``: dispatcher threads
        observe while exporters ``asdict``-iterate the field, and an
        in-place mutation would change the dict under the iterator.
        """
        h = self.registry.histogram("latency_s", kind=kind)
        h.record(seconds)
        view = {k: round(v, 9) for k, v in h.percentiles().items()}
        with self._latency_lock():
            fresh = dict(self.latency_percentiles)
            fresh[kind] = view
            self.latency_percentiles = fresh

    def publish(self) -> dict:
        """Export scalar dataclass fields + histograms as one flat dict."""
        reg = self.registry
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, bool):
                reg.gauge(f.name, float(v))
            elif isinstance(v, (int, float)):
                reg.gauge(f.name, v)
            elif isinstance(v, dict) and f.name == "reduce_rounds":
                for impl, n in v.items():
                    reg.gauge("reduce_rounds", n, impl=impl)
        return reg.export()
