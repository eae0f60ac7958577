"""OpenMetrics exporter — the port's :class:`~repro_torch.obs.Registry` as
scrapeable text.

The port's counterpart of the reference's ``obs/export.py``, pure Python
and rule for rule the same, so the same registry content renders to the
same bytes in both packages.  :func:`to_openmetrics` renders one registry
snapshot as OpenMetrics text; :class:`MetricsServer` serves it over a
stdlib HTTP endpoint on ``127.0.0.1`` (``fca serve --metrics-port``), so
a Prometheus scraper — or ``curl`` — reads the live queue-depth gauges,
shed counters and latency histograms while the admission queue is under
load.

Rendering rules (the strict subset of OpenMetrics 1.0 emitted here, all
enforced by :func:`parse_openmetrics`, the round-trip validator):

* metric names sanitize to ``[a-zA-Z_:][a-zA-Z0-9_:]*``; a trailing
  ``_s`` (the registry's seconds convention) renders as ``_seconds``.
* counter sample names end in ``_total`` (the family name drops it).
* histograms emit cumulative ``_bucket{le="..."}`` series over the
  registry's log-bucket upper edges — including the explicit underflow
  bucket at the 1 µs floor — plus ``_count`` and ``_sum``; the
  ``le="+Inf"`` bucket equals ``_count``.
* label values escape ``\\``, ``"`` and newlines; families are sorted,
  each declared once, and the exposition ends with ``# EOF``.

``python -m repro_torch.obs.export FILE`` validates a saved exposition
(``fca serve --metrics-dump FILE`` writes one).
"""

from __future__ import annotations

import math
import re
import threading

from repro_torch.obs.metrics import Histogram, Registry

CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_BAD_CHARS = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    """A registry metric name as an OpenMetrics family name."""
    if name.endswith("_s"):
        name = name[:-2] + "_seconds"
    name = _BAD_CHARS.sub("_", name)
    if not name or not _NAME_OK.match(name):
        name = "_" + name
    return name


def _escape(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels_str(labels, extra=()) -> str:
    items = [*labels, *extra]
    if not items:
        return ""
    body = ",".join(
        f'{_BAD_CHARS.sub("_", str(k))}="{_escape(v)}"' for k, v in items
    )
    return "{" + body + "}"


def _num(v: float) -> str:
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _histogram_lines(name: str, labels, h: Histogram) -> list[str]:
    out = []
    cum = 0
    for edge, count in h.bucket_edges():
        cum += count
        out.append(
            f"{name}_bucket{_labels_str(labels, (('le', _num(edge)),))} {cum}"
        )
    out.append(f"{name}_bucket{_labels_str(labels, (('le', '+Inf'),))} {h.count}")
    out.append(f"{name}_count{_labels_str(labels)} {h.count}")
    out.append(f"{name}_sum{_labels_str(labels)} {_num(h.sum)}")
    return out


def to_openmetrics(registry: Registry, *, help_text: dict | None = None) -> str:
    """Render one registry snapshot as OpenMetrics text.

    ``help_text`` optionally maps *registry* metric names to HELP lines.
    The output always terminates with ``# EOF`` and round-trips
    :func:`parse_openmetrics`.
    """
    help_text = help_text or {}
    lines: list[str] = []
    seen: set[str] = set()
    for name, typ, series in registry.families():
        fam = sanitize_name(name)
        if typ == "counter" and fam.endswith("_total"):
            fam = fam[: -len("_total")]
        if fam in seen:  # same name as two types: disambiguate by suffix
            fam = f"{fam}_{typ}"
        seen.add(fam)
        lines.append(f"# TYPE {fam} {typ}")
        if fam.endswith("_seconds"):
            lines.append(f"# UNIT {fam} seconds")
        if name in help_text:
            lines.append(f"# HELP {fam} {_escape(help_text[name])}")
        for labels, value in series:
            if typ == "counter":
                lines.append(f"{fam}_total{_labels_str(labels)} {_num(value)}")
            elif typ == "gauge":
                lines.append(f"{fam}{_labels_str(labels)} {_num(value)}")
            else:
                lines.extend(_histogram_lines(fam, labels, value))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# validator / parser — the acceptance check "parses as valid OpenMetrics"
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>[^ ]+))?$"
)
_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<val>(?:[^"\\]|\\.)*)"'
)
_SUFFIXES = {
    "counter": ("_total", "_created"),
    "histogram": ("_bucket", "_count", "_sum", "_created"),
    "gauge": ("",),
}


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    return float(s)  # raises ValueError on junk — caller wraps


def parse_openmetrics(text: str) -> dict:
    """Parse (and strictly validate) an OpenMetrics exposition.

    Returns ``{family: {"type": ..., "samples": [(name, labels, value)]}}``.
    Raises ``ValueError`` on: missing ``# EOF`` terminator, samples with
    no prior TYPE declaration, sample names outside the family's allowed
    suffix set, re-declared families, malformed label syntax,
    non-cumulative histogram buckets, or a ``+Inf`` bucket that
    disagrees with ``_count``.
    """
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition must terminate with '# EOF'")
    families: dict[str, dict] = {}
    for i, line in enumerate(lines[:-1]):
        if not line:
            raise ValueError(f"line {i}: blank lines are not allowed")
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[0] != "#":
                raise ValueError(f"line {i}: malformed metadata {line!r}")
            kind, fam = parts[1], parts[2]
            if kind == "TYPE":
                typ = parts[3] if len(parts) > 3 else ""
                if typ not in _SUFFIXES:
                    raise ValueError(f"line {i}: unsupported type {typ!r}")
                if fam in families:
                    raise ValueError(f"line {i}: family {fam!r} re-declared")
                if not _NAME_OK.match(fam):
                    raise ValueError(f"line {i}: invalid family name {fam!r}")
                families[fam] = {"type": typ, "samples": []}
            elif kind in ("HELP", "UNIT"):
                if fam not in families:
                    raise ValueError(
                        f"line {i}: {kind} for undeclared family {fam!r}"
                    )
            elif kind == "EOF":
                raise ValueError(f"line {i}: '# EOF' before the last line")
            else:
                raise ValueError(f"line {i}: unknown metadata {kind!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample {line!r}")
        name = m.group("name")
        raw = m.group("labels")
        labels: dict[str, str] = {}
        if raw:
            consumed = _LABEL_RE.sub("", raw).replace(",", "").strip()
            if consumed:
                raise ValueError(f"line {i}: malformed labels {raw!r}")
            labels = {g["key"]: g["val"] for g in _LABEL_RE.finditer(raw)}
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {i}: non-numeric value {m.group('value')!r}"
            ) from None
        fam = _family_of(name, labels, families)
        if fam is None:
            raise ValueError(
                f"line {i}: sample {name!r} has no TYPE-declared family"
            )
        families[fam]["samples"].append((name, labels, value))
    for fam, info in families.items():
        if info["type"] == "histogram":
            _check_histogram(fam, info["samples"])
    return families


def _family_of(name: str, labels: dict, families: dict) -> str | None:
    for fam, info in families.items():
        for suf in _SUFFIXES[info["type"]]:
            if name == fam + suf:
                if suf == "_bucket" and "le" not in labels:
                    raise ValueError(
                        f"histogram bucket sample {name!r} lacks an 'le' label"
                    )
                return fam
    return None


def _check_histogram(fam: str, samples: list) -> None:
    """Cumulative monotone buckets; +Inf bucket == _count, per series."""
    by_series: dict[tuple, dict] = {}
    for name, labels, value in samples:
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        s = by_series.setdefault(key, {"buckets": [], "count": None})
        if name == fam + "_bucket":
            s["buckets"].append((_parse_value(labels["le"]), value))
        elif name == fam + "_count":
            s["count"] = value
    for key, s in by_series.items():
        buckets = sorted(s["buckets"])
        if not buckets:
            continue
        counts = [c for _, c in buckets]
        if counts != sorted(counts):
            raise ValueError(
                f"{fam}{dict(key)}: histogram buckets are not cumulative"
            )
        if buckets[-1][0] != math.inf:
            raise ValueError(f"{fam}{dict(key)}: missing le=\"+Inf\" bucket")
        if s["count"] is not None and buckets[-1][1] != s["count"]:
            raise ValueError(
                f"{fam}{dict(key)}: +Inf bucket {buckets[-1][1]} != "
                f"_count {s['count']}"
            )


# ---------------------------------------------------------------------------
# stdlib HTTP endpoint
# ---------------------------------------------------------------------------


class MetricsServer:
    """``GET /metrics`` over ``http.server`` in a daemon thread.

    ``provider`` is a zero-arg callable returning the live
    :class:`Registry` — called per scrape, so the endpoint always
    renders the current snapshot (registry reads are lock-protected
    against the dispatcher's concurrent writes).  It binds ``127.0.0.1``
    only; ``port=0`` binds an ephemeral port, read back from :attr:`port`.
    """

    host = "127.0.0.1"

    def __init__(self, provider, port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404, "try /metrics")
                    return
                body = to_openmetrics(provider()).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet — scrapes aren't app logs
                pass

        self._server = ThreadingHTTPServer((self.host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="repro-torch-metrics",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def main(argv=None):
    """``python -m repro_torch.obs.export FILE`` — validate a saved exposition."""
    import argparse
    import json
    import sys

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("file", help="OpenMetrics text exposition to validate")
    args = p.parse_args(argv)
    with open(args.file) as f:
        text = f.read()
    try:
        families = parse_openmetrics(text)
    except ValueError as e:
        print(f"INVALID OpenMetrics exposition: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "families": len(families),
        "samples": sum(len(v["samples"]) for v in families.values()),
        "histograms": sum(
            1 for v in families.values() if v["type"] == "histogram"
        ),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
