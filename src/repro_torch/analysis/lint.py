"""Pass 2 — host-sync, wall-clock, and recompile-hazard linter.

AST-level rules over ``src/repro_torch``:

* ``host-sync`` — no host read of a device value inside the *async driver
  regions* (the ``_*_async`` round loops in ``repro_torch.core.mr`` and the
  speculative ``spec_*``/``reconcile_*`` orchestration in
  ``repro_torch.core.frontier``): ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``np.asarray(...)``, ``host_bits(...)`` (the port's D2H
  idiom), ``torch.cuda.synchronize()`` and an ``Event`` / ``Stream``
  ``.synchronize()``.  Those loops exist to keep rounds in flight; a stray
  sync collapses the double-buffering.  The blessed reconcile points
  (``_download``, ``_download_packed``, ``_block_scalar``) are
  allowlisted; ad-hoc exceptions annotate the line with ``# sync: ok``.

* ``wall-clock`` — no direct ``time.time()`` / ``time.monotonic()`` /
  ``time.perf_counter()`` *calls* in clock-injectable serve/loadgen/query
  code (the virtual-clock test harnesses and the schedule fuzzer depend
  on every read going through the injected ``clock``).  Bare attribute
  references in keyword defaults (``clock=time.monotonic``) are the
  injection mechanism itself and stay legal.  Annotate ``# clock: ok``.

* ``mutable-default`` — no mutable default arguments anywhere (classic
  shared-state bug).

* ``jit-in-loop`` — no recompile or rebuild inside a ``for``/``while``
  body: ``torch.compile(...)``, ``torch.jit.script`` / ``torch.jit.trace``
  (each iteration makes a fresh callable with an empty compile cache),
  and ``kernels._build.build(...)`` / ``kernels._build.load(...)`` (an
  ``nvcc`` build or a library load per iteration).

* ``bare-except`` — no bare ``except:`` (swallows KeyboardInterrupt and
  masks device/collective failures as empty results).

The allowlist (``allowlist.json``) maps rule -> ["path::qualname", ...];
inline annotations handle one-off lines.  Both are deliberate, visible
opt-outs — the strict gate treats everything else as an error.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re

from repro_torch.analysis.findings import Finding

# async driver regions: file (repo-relative, posix) -> function-name regexes
ASYNC_SCOPES = {
    "src/repro_torch/core/mr.py": (r".*_async$",),
    "src/repro_torch/core/frontier.py": (
        r"^spec_", r"^reconcile_", r"^_reconcile", r"^discard_spec$",
        r"^_adopt_spec$", r"^_download", r"^_block_scalar$",
    ),
}

# clock-injectable tiers: every wall-clock read must go through the
# injected ``clock`` callable.  Entries ending in "/" scope a whole
# directory (the serve tier is clock-injectable wholesale).
CLOCK_SCOPES = (
    "src/repro_torch/serve/",
    "src/repro_torch/query/engine.py",
    "src/repro_torch/query/stream.py",
)


def _clock_scoped(rel: str) -> bool:
    return any(
        rel == s or (s.endswith("/") and rel.startswith(s))
        for s in CLOCK_SCOPES
    )


_WALL_CLOCK_FNS = {"time", "monotonic", "perf_counter", "monotonic_ns", "time_ns"}
# tensor methods that read a device value on the host (``.cpu()`` and
# ``.numpy()`` copy it, ``.item()`` / ``.tolist()`` convert it) and the
# waits on a device event, stream or the whole device
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# np.asarray of a tensor and host_bits are the D2H idioms; np.array(list,
# ...) host constructions are not syncs and stay legal
_SYNC_NP_FNS = {"asarray"}
_SYNC_FNS = {"host_bits"}
_REBUILD_FNS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
_REBUILD_SUFFIXES = ("_build.build", "_build.load")

_DEFAULT_ALLOWLIST = pathlib.Path(__file__).with_name("allowlist.json")


def load_allowlist(path=None) -> dict:
    p = pathlib.Path(path) if path else _DEFAULT_ALLOWLIST
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    return {rule: set(entries) for rule, entries in data.items()}


def _line_has_marker(source_lines, lineno: int, marker: str) -> bool:
    if 1 <= lineno <= len(source_lines):
        return marker in source_lines[lineno - 1]
    return False


def _dotted(node) -> str | None:
    """'np.asarray' / 'time.monotonic' / 'torch.compile' for an Attribute/Name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_rebuild(name: str) -> bool:
    return name in _REBUILD_FNS or name.endswith(_REBUILD_SUFFIXES)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, source: str, allow: dict):
        self.rel = rel
        self.lines = source.splitlines()
        self.allow = allow
        self.findings: list[Finding] = []
        self.stack: list[str] = []  # qualname segments
        self.loop_depth = 0
        self.async_patterns = [
            re.compile(p) for p in ASYNC_SCOPES.get(rel, ())
        ]
        self.clock_scoped = _clock_scoped(rel)
        self.async_depth = 0  # inside a function matching async_patterns

    # -- helpers -----------------------------------------------------------

    def _qualname(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _allowed(self, rule: str) -> bool:
        entries = self.allow.get(rule, ())
        qn = self._qualname()
        return f"{self.rel}::{qn}" in entries

    def _emit(self, rule: str, node, msg: str, marker: str | None = None):
        if marker and _line_has_marker(self.lines, node.lineno, marker):
            return
        if self._allowed(rule):
            return
        self.findings.append(
            Finding("lint", rule, f"{self.rel}:{node.lineno}", msg)
        )

    # -- scopes ------------------------------------------------------------

    def _visit_func(self, node):
        for d in node.args.defaults + [
            d for d in node.args.kw_defaults if d is not None
        ]:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call)
                and _dotted(d.func) in ("list", "dict", "set", "bytearray")
            ):
                self._emit(
                    "mutable-default", d,
                    f"mutable default argument in {self._qualname()}."
                    f"{node.name} — shared across calls",
                )
        is_async_scope = any(p.search(node.name) for p in self.async_patterns)
        self.stack.append(node.name)
        if is_async_scope:
            self.async_depth += 1
        outer_loop = self.loop_depth
        self.loop_depth = 0  # a nested def is a fresh loop context
        self.generic_visit(node)
        self.loop_depth = outer_loop
        if is_async_scope:
            self.async_depth -= 1
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_loop(self, node):
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop

    # -- rules -------------------------------------------------------------

    def _host_sync(self, node) -> str | None:
        """What a call reads on the host, or None: ``x.item()`` and the
        other tensor methods, ``np.asarray(...)``, ``host_bits(...)``."""
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
            return f".{f.attr}()"
        name = _dotted(f)
        if name is None:
            return None
        root, leaf = name.split(".", 1)[0], name.rsplit(".", 1)[-1]
        if (root in ("np", "numpy") and leaf in _SYNC_NP_FNS) or name in _SYNC_FNS:
            return f"{name}()"
        return None

    def visit_Call(self, node):
        if self.async_depth:
            what = self._host_sync(node)
            if what is not None:
                self._emit(
                    "host-sync", node,
                    f"{what} inside async driver region "
                    f"{self._qualname()} — blocks the in-flight round; "
                    "route through the blessed reconcile points or "
                    "annotate '# sync: ok'",
                    marker="# sync: ok",
                )
        name = _dotted(node.func)
        if name:
            root = name.split(".", 1)[0]
            leaf = name.rsplit(".", 1)[-1]
            if (
                self.clock_scoped
                and root == "time"
                and leaf in _WALL_CLOCK_FNS
            ):
                self._emit(
                    "wall-clock", node,
                    f"direct {name}() in clock-injectable code "
                    f"({self._qualname()}) — read the injected clock "
                    "instead, or annotate '# clock: ok'",
                    marker="# clock: ok",
                )
            if self.loop_depth and _is_rebuild(name):
                self._emit(
                    "jit-in-loop", node,
                    f"{name} called inside a loop in {self._qualname()} — "
                    "every iteration recompiles or rebuilds from scratch",
                )
        self.generic_visit(node)

    def visit_ExceptHandler(self, node):
        if node.type is None:
            self._emit(
                "bare-except", node,
                f"bare 'except:' in {self._qualname()} — catches "
                "KeyboardInterrupt/SystemExit and masks collective failures",
            )
        self.generic_visit(node)


def lint_file(path, rel: str, allow: dict) -> list[Finding]:
    source = pathlib.Path(path).read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [
            Finding("lint", "syntax-error", f"{rel}:{e.lineno}", str(e))
        ]
    linter = _Linter(rel, source, allow)
    linter.visit(tree)
    return linter.findings


def run(report, *, root=None, allowlist_path=None, extra_files=()) -> list[Finding]:
    """Lint every ``repro_torch`` source file under ``root`` (the repo root)."""
    root = pathlib.Path(root) if root else _repo_root()
    allow = load_allowlist(allowlist_path)
    findings = []
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [
        pathlib.Path(f) for f in extra_files
    ]
    for path in files:
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        findings.extend(lint_file(path, rel, allow))
        report.note_checked("lint", "files")
    return findings


def _repo_root() -> pathlib.Path:
    # src/repro_torch/analysis/lint.py -> repo root three levels up from src/
    return pathlib.Path(__file__).resolve().parents[3]
