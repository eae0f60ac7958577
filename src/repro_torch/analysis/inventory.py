"""``--inventory`` — import-graph reachability over ``src/repro_torch``.

Builds the module import graph by AST (absolute ``repro_torch.*`` imports
and relative imports, including ``from pkg import submodule`` edges),
walks reachability from the package's public surfaces, and reports what
nothing reaches — the dead-code census committed as
``ANALYSIS_inventory_torch.json`` so a PR that orphans a module shows up as
a diff on the report.  (``ANALYSIS_inventory.json`` is the JAX package's
census and is not written here.)

Roots are the FCA product surfaces: the tier package ``__init__``
re-exports (core/dist/query/rules/serve/kernels/obs), the CLI mains, and
the FCA launchers.  The LM seed stack (configs/models and its launchers)
is reachable only through its own entry points — it is listed separately,
not mixed into the dead set; seed roots the port does not hold yet are
skipped.
"""

from __future__ import annotations

import ast
import json
import pathlib

ROOTS = (
    "repro_torch.core",
    "repro_torch.dist",
    "repro_torch.query",
    "repro_torch.rules",
    "repro_torch.serve",
    "repro_torch.kernels",
    "repro_torch.obs",
    "repro_torch.obs.__main__",
    "repro_torch.analysis",
    "repro_torch.analysis.__main__",
    "repro_torch.launch.fca",
    "repro_torch.launch.mesh",
)

# pre-FCA LM seed surfaces: reachable from their own mains, reported as
# their own tier so the dead-code list stays actionable
SEED_ROOTS = (
    "repro_torch.launch.train",
    "repro_torch.launch.serve",
    "repro_torch.launch.data",
    "repro_torch.launch.dryrun",
)

# packages that load their submodules dynamically (importlib registries):
# the static graph cannot see those edges, so a reachable package pulls in
# every submodule under it
DYNAMIC_PKGS = ("repro_torch.configs",)


def _module_name(path: pathlib.Path, src: pathlib.Path) -> str:
    rel = path.relative_to(src).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _edges(tree: ast.Module, module: str, known: set) -> set:
    """Outgoing import edges of one module, resolved against the known
    module set (``from pkg import name`` links ``pkg.name`` when that is
    itself a module)."""
    pkg_parts = module.split(".")
    out = set()

    def add(name: str):
        if name in known:
            out.add(name)
            return
        # importing a symbol from a package/module: credit the container
        while "." in name:
            name = name.rsplit(".", 1)[0]
            if name in known:
                out.add(name)
                return

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                prefix = ".".join(pkg_parts[: len(pkg_parts) - node.level])
                mod = f"{prefix}.{node.module}" if node.module else prefix
            else:
                mod = node.module or ""
            if mod:
                add(mod)
                for alias in node.names:
                    add(f"{mod}.{alias.name}")
    return out


def build_inventory(root=None) -> dict:
    root = pathlib.Path(root) if root else _repo_root()
    src = root / "src"
    files = sorted((src / "repro_torch").rglob("*.py"))
    modules = {_module_name(p, src): p for p in files}
    known = set(modules)
    graph, stats = {}, {}
    for name, path in modules.items():
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        graph[name] = _edges(tree, name, known)
        defs = [
            n.name
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        ]
        stats[name] = {
            "path": path.relative_to(root).as_posix(),
            "loc": source.count("\n") + 1,
            "defs": len(defs),
            "public_defs": sum(1 for d in defs if not d.startswith("_")),
        }

    def reach(roots) -> set:
        seen = set()
        frontier = [r for r in roots if r in known]
        while frontier:
            m = frontier.pop()
            if m in seen:
                continue
            seen.add(m)
            # a package reaches its __init__ imports; a module reaches its
            # containing package __init__ implicitly
            if "." in m:
                frontier.append(m.rsplit(".", 1)[0])
            if m in DYNAMIC_PKGS:
                frontier.extend(
                    k for k in known if k.startswith(m + ".")
                )
            frontier.extend(graph.get(m, ()))
        return seen

    fca = reach(ROOTS)
    seed = reach(SEED_ROOTS) - fca

    # modules the test suite imports: not product-reachable but exercised
    test_imports = set()
    for tpath in sorted((root / "tests").glob("**/*.py")):
        try:
            ttree = ast.parse(tpath.read_text(), filename=str(tpath))
        except SyntaxError:
            continue
        test_imports |= _edges(ttree, "tests", known)
    test_only = reach(test_imports) - fca - seed

    dead = sorted(known - fca - seed - test_only)
    return {
        "roots": list(ROOTS),
        "seed_roots": list(SEED_ROOTS),
        "n_modules": len(known),
        "n_reachable": len(fca),
        "n_seed_tier": len(seed),
        "n_test_only": len(test_only),
        "seed_tier": sorted(seed),
        "test_only": sorted(test_only),
        "dead": [dict(module=m, **stats[m]) for m in dead],
        "loc_total": sum(s["loc"] for s in stats.values()),
        "loc_dead": sum(stats[m]["loc"] for m in dead),
    }


DEFAULT_PATH = "ANALYSIS_inventory_torch.json"


def write_inventory(path, root=None) -> dict:
    inv = build_inventory(root)
    pathlib.Path(path).write_text(json.dumps(inv, indent=2) + "\n")
    return inv


def _repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3]
