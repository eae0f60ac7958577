"""Span tracer — the round-level timeline of mining and serving.

Every host-side boundary the miners and servers cross — seed expansion,
closure dispatch, the blocked wait on the AND-allreduce's survivor count,
survivor download, query micro-batches, streaming stage/commit — records
a span, and the whole run exports as Chrome/Perfetto ``trace_event`` JSON
(load ``--trace out.json`` at https://ui.perfetto.dev).  A sync mine is a
strict staircase of ``mine/round[r]`` spans.

Two event families:

* **sync spans** (``ph: B``/``E``) — strictly nested host work on one
  track.  ``Tracer.span(name, **tags)`` is a context manager; tags land
  in ``args`` (shard-plan geometry, chunk sizes, survivor counts, ...).
* **async spans** (``ph: b``/``e`` + id) — device-overlapped work whose
  begin and end are observed from the host but whose extent crosses other
  spans.

The event schema is the reference package's, so either package's
:func:`validate_trace` accepts the other's saved trace.

Tracing is opt-in and OFF by default: the module-level current tracer is
a shared :class:`NoopTracer` whose ``span()`` returns one reusable null
context manager — no event dicts, no timestamps, no allocation.  Spans
sit only at host boundaries and never read a device value or synchronize
the device themselves: a span around a blocking read times the read that
was already there, so a traced run is bit-identical to an untraced one.

Device-side correlation: ``Tracer(profiler_annotations=True)`` enters a
``torch.profiler.record_function`` for every span, so host spans line up
with the profiler's own timeline, and :func:`start_device_trace` /
:func:`stop_device_trace` wrap a ``torch.profiler.profile`` (CPU, and CUDA
where a card is present) and export its Chrome trace into a directory.

``python -m repro_torch.obs.trace out.json`` validates a saved trace
(schema + span well-formedness; ``--expect-async-overlap`` additionally
requires a speculative dispatch overlapping an earlier in-flight round).
"""

from __future__ import annotations

import contextlib
import json
import re
import time


# Chrome trace_event phases we emit / accept.
_SYNC_PHASES = ("B", "E")
_ASYNC_PHASES = ("b", "e")
_PHASES = frozenset(_SYNC_PHASES + _ASYNC_PHASES + ("i", "M", "X", "C"))

# Strip instance indices for rollups: "mine/round[7]/expand" → "mine/round/expand".
_INDEX_RE = re.compile(r"\[\d+\]")


def _strip_index(name: str) -> str:
    return _INDEX_RE.sub("", name)


class _NullSpan:
    """The shared no-op span: enter/exit/set all do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **tags):  # end-tags (e.g. outcome=...) — dropped
        pass


_NULL_SPAN = _NullSpan()


class NoopTracer:
    """Default tracer: every operation is a no-op.

    Shared singleton (:data:`NOOP`); ``enabled`` lets hot sites skip even
    the tag-dict construction when they want to (the per-round call sites
    don't bother — one small dict per *round* is already below noise).
    """

    enabled = False

    def span(self, name, **tags):
        return _NULL_SPAN

    def instant(self, name, **tags):
        pass

    def begin_async(self, name, aid, **tags):
        pass

    def end_async(self, name, aid, **tags):
        pass


NOOP = NoopTracer()


class _Span:
    """One open sync span; emitted as a B event at enter, E at exit.

    ``set(**tags)`` adds end-tags (recorded on the E event) — used for
    outcomes only known when the work finishes (reconcile adopt/fallback).
    """

    __slots__ = ("_tracer", "name", "_end_tags")

    def __init__(self, tracer, name):
        self._tracer = tracer
        self.name = name
        self._end_tags = None

    def set(self, **tags):
        if self._end_tags is None:
            self._end_tags = {}
        self._end_tags.update(tags)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer._end(self.name, self._end_tags)
        return False


class Tracer:
    """Records spans and exports Chrome/Perfetto ``trace_event`` JSON.

    Timestamps are microseconds since the tracer's construction
    (``perf_counter``-based — monotone by construction).  Single host
    track (``pid``/``tid`` fixed): the mining/serving host loops are
    single-threaded, and device-overlapped work goes on *async* tracks
    via :meth:`begin_async`/:meth:`end_async` which Perfetto renders as
    separate rows, so overlap is visible without fake threads.
    """

    enabled = True

    def __init__(self, *, pid: int = 0, tid: int = 0, profiler_annotations: bool = False):
        self.events: list[dict] = []
        self.pid = pid
        self.tid = tid
        self._t0 = time.perf_counter()
        self._stack: list[str] = []
        self._annotation = None
        if profiler_annotations:
            from torch.profiler import record_function

            self._annotation = record_function

    # -- event plumbing ----------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, name: str, ph: str, *, cat: str = "host", args=None, aid=None):
        ev = {
            "name": name,
            "ph": ph,
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": self.tid,
            "cat": cat,
        }
        if args:
            ev["args"] = args
        if aid is not None:
            ev["id"] = aid
        self.events.append(ev)

    # -- sync spans --------------------------------------------------------

    def span(self, name: str, **tags) -> _Span:
        """Open a nested host span (context manager).  Tags become the B
        event's ``args``; tags added via ``.set()`` land on the E event."""
        self._stack.append(name)
        self._emit(name, "B", args=tags or None)
        span = _Span(self, name)
        if self._annotation is not None:
            return _AnnotatedSpan(span, self._annotation(name))
        return span

    def _end(self, name: str, end_tags):
        if not self._stack or self._stack[-1] != name:  # defensive: never raise
            # mismatched exit (a span leaked across an exception unwinding
            # another) — close what's open so the trace stays well-formed
            while self._stack and self._stack[-1] != name:
                self._emit(self._stack.pop(), "E")
        if self._stack:
            self._stack.pop()
        self._emit(name, "E", args=end_tags)

    def instant(self, name: str, **tags):
        """A zero-duration marker (Chrome ``i`` event)."""
        ev_args = tags or None
        ev = {
            "name": name,
            "ph": "i",
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": self.tid,
            "cat": "host",
            "s": "t",  # thread-scoped instant
        }
        if ev_args:
            ev["args"] = ev_args
        self.events.append(ev)

    # -- async (device-overlapped) spans ------------------------------------

    def begin_async(self, name: str, aid: int, **tags):
        """Begin a device-overlapped span (Chrome async ``b``).  ``aid``
        correlates begin/end and must be unique per in-flight span (the
        miners use the round sequence number)."""
        self._emit(name, "b", cat="round", args=tags or None, aid=aid)

    def end_async(self, name: str, aid: int, **tags):
        self._emit(name, "e", cat="round", args=tags or None, aid=aid)

    # -- export ------------------------------------------------------------

    def to_dict(self) -> dict:
        """The Perfetto-loadable JSON object (round-trips ``json.loads``)."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {"tracer": "repro_torch.obs", "clock": "perf_counter_us"},
        }

    def save(self, path: str) -> None:
        # close any spans an exception left open so the file validates
        while self._stack:
            self._emit(self._stack.pop(), "E")
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    def rollup(self) -> dict:
        """Aggregate spans by index-stripped name — see :func:`span_rollup`."""
        return span_rollup(self.events)


class _AnnotatedSpan:
    """A host span that also enters a ``torch.profiler.record_function``."""

    __slots__ = ("_span", "_ann")

    def __init__(self, span, ann):
        self._span = span
        self._ann = ann

    def set(self, **tags):
        self._span.set(**tags)

    def __enter__(self):
        try:
            self._ann.__enter__()
        except Exception:
            self._ann = None
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                pass
        return False


# ---------------------------------------------------------------------------
# current-tracer plumbing (module-level; host loops are single-threaded)
# ---------------------------------------------------------------------------

_CURRENT: NoopTracer | Tracer = NOOP


def current():
    """The active tracer (the shared no-op unless one was installed)."""
    return _CURRENT


def set_tracer(tracer) -> None:
    global _CURRENT
    _CURRENT = tracer if tracer is not None else NOOP


@contextlib.contextmanager
def use_tracer(tracer):
    """Install ``tracer`` for the duration of a ``with`` block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else NOOP
    try:
        yield tracer
    finally:
        _CURRENT = prev


# ---------------------------------------------------------------------------
# device trace: a torch.profiler session beside the host tracer
# ---------------------------------------------------------------------------

_DEVICE_TRACE: dict = {}

# The file a device trace is exported to, inside the directory given to
# :func:`start_device_trace`.
DEVICE_TRACE_FILE = "device_trace.json"


def start_device_trace(log_dir: str) -> bool:
    """Start a ``torch.profiler.profile`` session (CPU activity, and CUDA
    activity where a card is present) whose Chrome trace
    :func:`stop_device_trace` exports to ``log_dir/device_trace.json``.
    Returns False (instead of raising) when the profiler cannot start or a
    session is already running — host tracing keeps working either way."""
    import os

    import torch

    if _DEVICE_TRACE:
        return False
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception:
        return False
    os.makedirs(log_dir, exist_ok=True)
    _DEVICE_TRACE.update(prof=prof, path=os.path.join(log_dir, DEVICE_TRACE_FILE))
    return True


def stop_device_trace() -> bool:
    """Stop the running device-trace session and export its Chrome trace.
    Returns False when no session was running or the export failed."""
    if not _DEVICE_TRACE:
        return False
    prof, path = _DEVICE_TRACE.pop("prof"), _DEVICE_TRACE.pop("path")
    try:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
    except Exception:
        return False
    return True


# ---------------------------------------------------------------------------
# validation + rollup (shared by tests, CI, and the CLI's span_rollup)
# ---------------------------------------------------------------------------


def validate_trace(obj) -> dict:
    """Validate a trace object (as loaded by ``json.loads``).

    Checks the Chrome ``trace_event`` schema subset we emit plus span
    well-formedness: every ``B`` has a matching ``E`` (properly nested per
    track), every async ``b`` has its ``e`` (matched by ``(name, id)``),
    and timestamps are monotone non-decreasing in emission order per
    track.  Returns a summary dict; raises ``ValueError`` on any
    violation.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be an object with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    stacks: dict[tuple, list[str]] = {}
    last_ts: dict[tuple, float] = {}
    open_async: dict[tuple, int] = {}
    n_spans = n_async = max_depth = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing required key {key!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has invalid ts {ev['ts']!r}")
        track = (ev["pid"], ev["tid"])
        if ev["ts"] < last_ts.get(track, 0.0):
            raise ValueError(
                f"event {i} ({ev['name']!r}): ts {ev['ts']} precedes the "
                f"track's previous event ({last_ts[track]}) — timestamps "
                "must be monotone per track"
            )
        last_ts[track] = ev["ts"]
        if ph == "B":
            stacks.setdefault(track, []).append(ev["name"])
            max_depth = max(max_depth, len(stacks[track]))
        elif ph == "E":
            stack = stacks.get(track) or []
            if not stack:
                raise ValueError(f"event {i}: E {ev['name']!r} with no open B")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(
                    f"event {i}: E {ev['name']!r} does not match the "
                    f"innermost open B {top!r} — spans must nest"
                )
            n_spans += 1
        elif ph == "b":
            key = (ev["name"], ev.get("id"))
            open_async[key] = open_async.get(key, 0) + 1
        elif ph == "e":
            key = (ev["name"], ev.get("id"))
            if open_async.get(key, 0) <= 0:
                raise ValueError(
                    f"event {i}: async e {key!r} with no matching b"
                )
            open_async[key] -= 1
            n_async += 1
    for track, stack in stacks.items():
        if stack:
            raise ValueError(f"track {track}: unclosed B spans {stack!r}")
    dangling = {k: v for k, v in open_async.items() if v}
    if dangling:
        raise ValueError(f"unclosed async spans: {dangling!r}")
    return {
        "events": len(events),
        "spans": n_spans,
        "async_spans": n_async,
        "max_depth": max_depth,
    }


def async_overlaps(obj) -> list[dict]:
    """Speculative overlap census: host spans that begin while an async
    round span (``cat: round``) with a *different* id is still in flight.

    A sync mine has none; an async mine's ``spec/dispatch[r+1]`` spans
    must appear here, overlapping ``mine/round[r]`` — the visual (and now
    testable) signature of the speculative scheduler.
    """
    events = obj["traceEvents"]
    # async round windows: (begin_ts, end_ts, id, name)
    begins: dict = {}
    windows = []
    for ev in events:
        if ev.get("cat") != "round":
            continue
        key = (ev["name"], ev.get("id"))
        if ev["ph"] == "b":
            begins[key] = ev["ts"]
        elif ev["ph"] == "e" and key in begins:
            windows.append(
                {"name": ev["name"], "id": ev.get("id"),
                 "t0": begins.pop(key), "t1": ev["ts"]}
            )
    out = []
    for ev in events:
        if ev["ph"] != "B":
            continue
        for w in windows:
            if w["t0"] < ev["ts"] < w["t1"] and ev["name"] != w["name"]:
                out.append(
                    {"span": ev["name"], "ts": ev["ts"],
                     "in_flight": w["name"], "round_id": w["id"]}
                )
                break
    return out


def span_rollup(events) -> dict:
    """Aggregate completed spans by index-stripped name.

    Returns ``{name: {count, total_s, mean_s, max_s, p50_s, p95_s,
    p99_s}}`` — percentiles via the same log-bucketed histogram the
    metrics registry uses, so the CLI's ``span_rollup`` and
    ``latency_percentiles`` read on one scale.  Covers sync B/E pairs and
    async b/e pairs (matched by ``(name, id)``).
    """
    from repro_torch.obs.metrics import Histogram

    hists: dict[str, Histogram] = {}
    stack: dict[tuple, list] = {}
    open_async: dict[tuple, float] = {}

    def observe(name: str, dur_us: float):
        h = hists.setdefault(_strip_index(name), Histogram())
        h.record(max(dur_us, 0.0) / 1e6)

    for ev in events:
        ph = ev.get("ph")
        track = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stack.setdefault(track, []).append((ev["name"], ev["ts"]))
        elif ph == "E":
            if stack.get(track):
                name, t0 = stack[track].pop()
                observe(name, ev["ts"] - t0)
        elif ph == "b":
            open_async[(ev["name"], ev.get("id"))] = ev["ts"]
        elif ph == "e":
            t0 = open_async.pop((ev["name"], ev.get("id")), None)
            if t0 is not None:
                observe(ev["name"], ev["ts"] - t0)
    return {
        name: {
            "count": h.count,
            "total_s": round(h.sum, 6),
            "mean_s": round(h.sum / h.count, 6) if h.count else 0.0,
            "max_s": round(h.max, 6),
            **{f"{k}_s": round(v, 6) for k, v in h.percentiles().items()},
        }
        for name, h in sorted(hists.items())
    }


def main(argv=None):
    """``python -m repro_torch.obs.trace TRACE.json [--expect-async-overlap]``"""
    import argparse
    import sys

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("trace", help="Perfetto trace_event JSON to validate")
    p.add_argument("--expect-async-overlap", action="store_true",
                   help="require at least one speculative dispatch span "
                        "overlapping an earlier in-flight round span")
    args = p.parse_args(argv)
    with open(args.trace) as f:
        obj = json.load(f)
    try:
        summary = validate_trace(obj)
    except ValueError as e:
        print(f"INVALID trace: {e}", file=sys.stderr)
        return 1
    overlaps = async_overlaps(obj)
    summary["overlapping_spans"] = len(overlaps)
    print(json.dumps(summary))
    if args.expect_async_overlap and not any(
        o["span"].startswith("spec/dispatch") for o in overlaps
    ):
        print(
            "INVALID trace: no spec/dispatch span overlaps an in-flight "
            "round (expected for --rounds async)",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
