"""Pass 3 — lock-discipline checker for the serve tier.

For each configured class the checker infers, from the AST alone:

* its **lock attributes** — ``self.X = threading.Lock()/RLock()``
  assignments in ``__init__``/``__post_init__``;
* its **guarded field set** — instance attributes accessed at least once
  inside a ``with self.<lock>:`` block outside ``__init__`` (the
  convention the serve tier documents: a field the code bothers to lock
  anywhere is a field the dispatcher thread can race on);
* **lock-held propagation** — a private method whose every in-class call
  site is lock-held (e.g. ``Registry._resolve``, documented "callers
  hold the lock") is analyzed with its body lock-held, to a fixpoint;
* its **entry points** — public methods/properties plus configured
  dispatcher-thread entries (``AdmissionQueue._run`` etc.).

A finding is an access to a guarded-and-mutated field that is (a) not
under any lock after propagation, (b) reachable from an entry point, and
(c) not annotated ``# lock: ok`` (the visible opt-out for benign racy
reads — GIL-atomic single reference/dict reads).

Only *mutated* fields are reported (assigned, subscript-assigned, or hit
with a known container mutator outside ``__init__``): an unguarded read
of a reference that is never rebound or mutated cannot race.  Accesses
through local aliases (``q = self._queues[k]; q.append(...)``) are
outside the checker's static reach — the schedule-fuzzing harness
(:mod:`repro_torch.analysis.fuzz`) covers those dynamically.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

from repro_torch.analysis.findings import Finding

# (repo-relative file, class, extra entry points run by other threads)
TARGETS = (
    ("src/repro_torch/serve/admission.py", "AdmissionQueue",
     ("_run", "_dispatch", "_take")),
    ("src/repro_torch/query/stream.py", "StreamUpdater", ("_stage",)),
    ("src/repro_torch/query/engine.py", "QueryEngine",
     ("_closure_step", "_topk_step", "_extents_step", "_rules_step")),
    ("src/repro_torch/obs/metrics.py", "Registry", ("_resolve",)),
    ("src/repro_torch/obs/metrics.py", "Histogram", ()),
    ("src/repro_torch/obs/metrics.py", "StatsBase", ("observe_latency",)),
)

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "remove", "discard", "clear", "sort",
}
# "lock" at a word/underscore boundary — matches _lock, _dispatch_lock,
# _latency_lock, but not "clock"
_LOCKISH = re.compile(r"(?:^|_)lock", re.IGNORECASE)
_INIT_METHODS = {"__init__", "__post_init__"}


@dataclasses.dataclass
class _Access:
    attr: str
    lineno: int
    under_lock: bool
    is_write: bool
    method: str


@dataclasses.dataclass
class _Call:
    callee: str
    under_lock: bool
    method: str


def _dotted(node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_lock(expr) -> bool:
    """True when a with-item context expression goes through an attribute
    or call whose name smells like a lock (``self._lock``,
    ``self.engine._frontier_lock``, ``self._latency_lock()``)."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and _LOCKISH.search(node.attr):
            return True
        if isinstance(node, ast.Name) and _LOCKISH.search(node.id):
            return True
    return False


class _MethodScan(ast.NodeVisitor):
    """Collects self-attribute accesses and self-method calls for one
    method body, tracking lexical ``with <lock>`` depth."""

    def __init__(self, method: str):
        self.method = method
        self.lock_depth = 0
        self.accesses: list[_Access] = []
        self.calls: list[_Call] = []

    def visit_With(self, node):
        locked = any(_mentions_lock(item.context_expr) for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if locked:
            self.lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if locked:
            self.lock_depth -= 1

    def _record(self, attrnode, is_write: bool):
        self.accesses.append(
            _Access(
                attr=attrnode.attr,
                lineno=attrnode.lineno,
                under_lock=self.lock_depth > 0,
                is_write=is_write,
                method=self.method,
            )
        )

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            self._record(node, isinstance(node.ctx, (ast.Store, ast.Del)))
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        t = node.target
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        ):
            self._record(t, True)
            self.visit(node.value)
            return
        self.generic_visit(node)

    def visit_Assign(self, node):
        # self.X[...] = v mutates X even though X itself is a Load
        for t in node.targets:
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Attribute)
                and isinstance(t.value.value, ast.Name)
                and t.value.value.id == "self"
            ):
                self._record(t.value, True)
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute):
            base = f.value
            # self.method(...)
            if isinstance(base, ast.Name) and base.id == "self":
                self.calls.append(
                    _Call(f.attr, self.lock_depth > 0, self.method)
                )
            # self.X.append(...) and friends mutate X
            if (
                f.attr in _MUTATORS
                and isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
            ):
                self._record(base, True)
        self.generic_visit(node)


@dataclasses.dataclass
class ClassAudit:
    """What the checker inferred for one class (also used by the tests)."""

    cls: str
    lock_attrs: set
    guarded: set
    mutated: set
    assumed_locked: set  # methods analyzed with a lock-held body
    reachable: set  # methods reachable from entry points
    findings: list


def _scan_class(node: ast.ClassDef):
    methods = {}
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan = _MethodScan(stmt.name)
            for s in stmt.body:
                scan.visit(s)
            methods[stmt.name] = scan
    return methods


def _lock_attrs(methods) -> set:
    out = set()
    for name in _INIT_METHODS:
        scan = methods.get(name)
        if scan is None:
            continue
        # re-derive from the accesses + ctor calls is brittle; just look
        # for self.X = threading.Lock()/RLock() assignment pairs by
        # matching write accesses whose line also constructs a lock —
        # cheaper: any written attr with a lockish name
        for acc in scan.accesses:
            if acc.is_write and _LOCKISH.search(acc.attr):
                out.add(acc.attr)
    # locks lazily (re)created outside __init__ (StatsBase fallback)
    for scan in methods.values():
        for acc in scan.accesses:
            if acc.is_write and _LOCKISH.search(acc.attr):
                out.add(acc.attr)
    return out


def audit_class(
    tree: ast.Module, rel: str, cls_name: str, extra_entries, source_lines
) -> ClassAudit | None:
    cls = next(
        (
            n
            for n in ast.walk(tree)
            if isinstance(n, ast.ClassDef) and n.name == cls_name
        ),
        None,
    )
    if cls is None:
        return None
    methods = _scan_class(cls)
    locks = _lock_attrs(methods)

    # fixpoint: private methods only ever called with the lock held are
    # analyzed lock-held (Registry._resolve's documented contract)
    assumed = set()
    while True:
        changed = False
        for name, scan in methods.items():
            if name in assumed or name in _INIT_METHODS:
                continue
            sites = [
                c
                for m, s in methods.items()
                for c in s.calls
                if c.callee == name and m not in _INIT_METHODS
            ]
            if sites and all(
                c.under_lock or c.method in assumed for c in sites
            ):
                if name.startswith("_") and not name.startswith("__"):
                    assumed.add(name)
                    changed = True
        if not changed:
            break

    def held(acc: _Access) -> bool:
        return acc.under_lock or acc.method in assumed

    body_accesses = [
        a
        for s in methods.values()
        for a in s.accesses
        if a.method not in _INIT_METHODS and a.attr not in locks
    ]
    guarded = {a.attr for a in body_accesses if held(a)}
    mutated = {a.attr for a in body_accesses if a.is_write}

    # reachability from entry points over the self-call graph
    entries = {
        m for m in methods if not m.startswith("_") and m not in _INIT_METHODS
    } | (set(extra_entries) & set(methods))
    reachable = set(entries)
    frontier = list(entries)
    while frontier:
        m = frontier.pop()
        for c in methods[m].calls:
            if c.callee in methods and c.callee not in reachable:
                reachable.add(c.callee)
                frontier.append(c.callee)

    findings = []
    for acc in body_accesses:
        if (
            acc.attr in guarded
            and acc.attr in mutated
            and not held(acc)
            and acc.method in reachable
        ):
            line = (
                source_lines[acc.lineno - 1]
                if acc.lineno - 1 < len(source_lines)
                else ""
            )
            if "# lock: ok" in line:
                continue
            findings.append(
                Finding(
                    "locks",
                    "unguarded-access",
                    f"{rel}:{acc.lineno}",
                    f"{cls_name}.{acc.method} touches self.{acc.attr} "
                    f"without holding a lock, but self.{acc.attr} is "
                    "lock-guarded elsewhere and mutated — either lock it "
                    "or annotate '# lock: ok' for a benign atomic read",
                )
            )
    return ClassAudit(
        cls=cls_name,
        lock_attrs=locks,
        guarded=guarded,
        mutated=mutated,
        assumed_locked=assumed,
        reachable=reachable,
        findings=findings,
    )


def audit_file(path, rel: str, targets) -> list:
    source = pathlib.Path(path).read_text()
    tree = ast.parse(source, filename=str(path))
    lines = source.splitlines()
    audits = []
    for cls_name, extra in targets:
        audit = audit_class(tree, rel, cls_name, extra, lines)
        if audit is not None:
            audits.append(audit)
    return audits


def run(report, *, root=None, targets=TARGETS) -> list[Finding]:
    root = pathlib.Path(root) if root else _repo_root()
    by_file: dict = {}
    for rel, cls, extra in targets:
        by_file.setdefault(rel, []).append((cls, extra))
    findings = []
    for rel, classes in by_file.items():
        path = root / rel
        if not path.exists():
            findings.append(
                Finding("locks", "missing-target", rel,
                        "configured lock-audit target file not found")
            )
            continue
        for audit in audit_file(path, rel, classes):
            findings.extend(audit.findings)
            report.note_checked("locks", "classes")
    return findings


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3]
