"""Package rules of the port: no JAX and no ``repro`` at run time, CUDA
by default with no silent fallback, and kernel wrappers that refuse
operands their kernels do not take."""

from __future__ import annotations

import ast
import json
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import kernels
from repro_torch.core import (
    ClosureEngine, all_closures, mrcbo, mrganter, mrganter_plus, paper_context,
)
from repro_torch.device import resolve_device
from repro_torch.interop import context_from_arrays, to_numpy
from repro_torch.kernels import _build, ops
from repro_torch.kernels import closure as kclosure
from repro_torch.kernels import frontier as fkern
from repro_torch.launch import fca

import _torch_reference  # noqa: F401,E402  (one torch thread per test process)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"


def _modules() -> list[str]:
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]


def _imported_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_jax_or_reference_imports_at_run_time():
    """A fresh interpreter imports every module of the port and everything
    chip_smoke.py imports; neither jax nor repro may be loaded after."""
    smoke_imports = sorted(n for n in _imported_names(CHIP_SMOKE) if n != "__future__")
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules() + smoke_imports!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.'))]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path", sorted(PACKAGE.rglob("*.py")) + [CHIP_SMOKE], ids=lambda p: p.name
)
def test_sources_name_no_jax_or_reference_module(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def test_serving_entry_points_default_to_cuda_and_never_fall_back():
    """The store, the bases, the rule index, the LM decoder, its serving
    engine and the LM serve CLI run on CUDA unless given ``device="cpu"``;
    without CUDA they raise instead of falling back."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.transformer import Decoder
    from repro_torch.query import ConceptStore
    from repro_torch.rules import RuleIndex, dg_basis, extract_bases, luxenburger_host
    from repro_torch.serve import ServeConfig, ServeEngine

    ctx = paper_context()
    intents = np.stack(all_closures(ctx))
    store = ConceptStore.build(ctx, intents, device="cpu")
    assert store.device.type == "cpu" and store.snapshot.intents.device.type == "cpu"
    basis = extract_bases(store)
    assert RuleIndex.build(basis, device="cpu").premise.device.type == "cpu"
    cfg = get_config("gemma2-9b").reduced()
    model = Decoder(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert ServeEngine(cfg, model, ServeConfig(), device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert ConceptStore(ctx).device.type == "cuda"
        assert Decoder(cfg).device.type == "cuda"
        return
    sup = store.snapshot.supports_np
    for call in (lambda: ConceptStore(ctx), lambda: ConceptStore.build(ctx, intents),
                 lambda: dg_basis(intents, sup, ctx.n_attrs),
                 lambda: luxenburger_host(intents, sup, ctx.n_objects),
                 lambda: RuleIndex.build(basis),
                 lambda: fca.main(["serve", "--dataset", "mushroom", "--scale", "0.01"]),
                 lambda: fca.main(["rules", "--dataset", "mushroom", "--scale", "0.01"]),
                 lambda: Decoder(cfg),
                 lambda: ServeEngine(cfg, model, ServeConfig()),
                 lambda: serve_cli.main(["--arch", "gemma2-9b", "--reduced"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_engine_defaults_to_cuda_and_never_falls_back():
    ctx = paper_context()
    if torch.cuda.is_available():
        assert ClosureEngine(ctx).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClosureEngine(ctx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fca.main(["mine", "--dataset", "mushroom", "--scale", "0.01"])


def test_cli_mines_on_the_cpu_when_asked(capsys):
    fca.main(["mine", "--dataset", "mushroom", "--scale", "0.01", "--algorithm", "mrcbo",
              "--device", "cpu", "--backend", "kernel", "--parts", "1"])
    out = json.loads(capsys.readouterr().out)
    assert (out["concepts"], out["iterations"], out["device"]) == (4440, 10, "cpu")
    assert out["modeled_comm_bytes"] == 0 and out["plan"]["n_parts"] == 1


@pytest.mark.parametrize("algorithm", ["mrganter+", "mrcbo", "mrganter"])
def test_cli_min_support_fraction(capsys, algorithm):
    fca.main(["mine", "--dataset", "mushroom", "--scale", "0.01", "--algorithm", algorithm,
              "--min-support", "0.25", "--local-prune", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["min_support_resolved"] == 21  # ceil(0.25 * 81)
    assert out["concepts"] > 1


@pytest.mark.parametrize("fn", [mrganter, mrganter_plus, mrcbo])
def test_async_rounds_need_the_device_pipeline(fn):
    """Async rounds overlap device futures; the host loop has none, so
    ``pipeline="host"`` with ``rounds="async"`` raises the reference's
    ValueError (as does an unknown rounds mode)."""
    ctx = paper_context()
    with pytest.raises(ValueError, match="pipeline='device'"):
        fn(ctx, ClosureEngine(ctx, device="cpu"), rounds="async", pipeline="host")
    with pytest.raises(ValueError, match="rounds mode"):
        fn(ctx, ClosureEngine(ctx, device="cpu"), rounds="eager")


def _bits(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize(
    "rows,cands,error",
    [
        (_bits(256, 4, dtype=torch.int64), _bits(8, 4), TypeError),
        (_bits(256, 4), _bits(8, 4, dtype=torch.uint8), TypeError),
        (_bits(256 * 4), _bits(8, 4), ValueError),
        (_bits(256, 4), _bits(8, 5), ValueError),
        (_bits(4, 256).t(), _bits(8, 256), ValueError),
        (_bits(256, 0), _bits(8, 0), ValueError),
        (torch.zeros((256, 4), dtype=torch.int32, device="meta"), _bits(8, 4), ValueError),
        (torch.zeros((256, 4), dtype=torch.int32, device="meta"),
         torch.zeros((8, 4), dtype=torch.int32, device="meta"), ValueError),
        (np.zeros((256, 4), np.int32), _bits(8, 4), TypeError),
    ],
    ids=["rows-int64", "cands-uint8", "1-D", "W-mismatch", "non-contiguous", "W=0",
         "device-mismatch", "meta-device", "numpy"],
)
def test_kernel_wrappers_refuse_bad_operands(rows, cands, error):
    with pytest.raises(error):
        kclosure.closure(rows, cands)
    mask = _bits(1, 4)
    with pytest.raises(error):
        fkern.fused_step(rows, cands, mask, (8, 0, 0, 0))


@pytest.mark.parametrize(
    "kwargs,error",
    [
        ({"mask": _bits(4)}, ValueError),
        ({"mask": _bits(1, 5)}, ValueError),
        ({"cbo": True}, ValueError),
        ({"cbo": True, "parent": _bits(8, 4), "lowrow": _bits(7, 4)}, ValueError),
        ({"cbo": True, "parent": _bits(8, 4, dtype=torch.int64), "lowrow": _bits(8, 4)},
         TypeError),
        ({"scalars": (2**31, 0, 0, 0)}, ValueError),
        ({"scalars": (1, 2, 3)}, ValueError),
    ],
    ids=["mask-1-D", "mask-width", "cbo-no-operands", "lowrow-shape", "parent-dtype",
         "scalar-range", "scalar-count"],
)
def test_fused_step_refuses_bad_operands(kwargs, error):
    args = {"mask": _bits(1, 4), "scalars": (8, 0, 0, 0)}
    args.update(kwargs)
    with pytest.raises(error):
        fkern.fused_step(_bits(256, 4), _bits(8, 4), args.pop("mask"), args.pop("scalars"),
                         **args)


def test_wide_contexts_still_go_through_the_kernel_wrapper(monkeypatch):
    """No width quietly leaves K1: batched_closure calls the wrapper at
    W = 520, past the reference kernel's MAX_W, and at W = 4000, past the
    H100's SIMT limit, where the CPU (which has no such limit) still
    answers.  On the card the limit comes from the library
    (``closure.max_w``, held at >= 3000 by chip_smoke.py's phase 3)."""
    calls = []
    real = kclosure.closure
    monkeypatch.setattr(kclosure, "closure", lambda r, c: calls.append(r.shape) or real(r, c))
    rows = torch.full((300, 520), -1, dtype=torch.int32)
    cands = torch.zeros((3, 520), dtype=torch.int32)
    c, s = ops.batched_closure(rows, cands, 520 * 32, n_valid_rows=300)
    assert calls == [torch.Size([300, 520])]  # K1 takes the rows as they are
    assert s.tolist() == [300, 300, 300]
    rows = torch.full((3, 4000), -1, dtype=torch.int32)
    c, s = ops.batched_closure(rows, cands[:, :1].repeat(1, 4000), 4000 * 32, n_valid_rows=3)
    assert calls[-1] == torch.Size([3, 4000]) and s.tolist() == [3, 3, 3]


@pytest.mark.parametrize("backend,fused", [("kernel", True), ("torch", False)])
@pytest.mark.parametrize("driver", [mrganter_plus, mrcbo])
def test_kernel_backend_routes_every_batched_step_through_k2(monkeypatch, backend, fused,
                                                             driver):
    calls = []
    real = fkern.fused_step
    monkeypatch.setattr(
        fkern, "fused_step", lambda *a, **k: calls.append(k.get("cbo", False)) or real(*a, **k)
    )
    ctx = paper_context()
    res = driver(ctx, ClosureEngine(ctx, backend=backend, device="cpu"), min_support=2)
    assert res.n_concepts > 1
    assert bool(calls) == fused


def test_launch_counters_count_only_kernel_launches():
    kernels.reset_launches()
    assert [k.launches for k in kernels.KERNELS] == [0] * len(kernels.KERNELS)
    ctx = paper_context()
    mrcbo(ctx, ClosureEngine(ctx, backend="kernel", device="cpu"))
    # CPU tensors run the plain versions: no kernel was launched
    assert [k.launches for k in kernels.KERNELS] == [0] * len(kernels.KERNELS)


def test_build_needs_nvcc_and_targets_an_ignored_directory(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension

    lib = _build.library_path("frontier")
    assert lib.is_relative_to(ROOT / "build")
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert lib == _build.library_path("frontier")  # deterministic name
    assert lib != _build.library_path("serve") != _build.library_path("attention")
    assert _build.SOURCES == ("frontier", "serve", "attention")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


@pytest.mark.parametrize("name,symbol,replaces", [
    ("frontier.cu", "closure_launch", "src/repro/kernels/closure.py:closure_pallas"),
    ("frontier.cu", "fused_step_launch", "src/repro/kernels/frontier.py:fused_closure_call"),
    ("frontier.cu", "map_closure_launch", "src/repro/kernels/frontier.py:map_closure_call"),
    ("frontier.cu", "filter_launch", "src/repro/kernels/frontier.py:filter_call"),
    ("serve.cu", "contains_topk_launch", "src/repro/kernels/serve.py:contains_topk_call"),
    ("serve.cu", "rules_topk_launch", "src/repro/kernels/serve.py:rules_topk_call"),
    ("attention.cu", "flash_attention_launch",
     "src/repro/kernels/flash_attention.py:flash_attention"),
])
def test_kernel_sources_state_what_they_replace(name, symbol, replaces):
    text = (PACKAGE / "csrc" / name).read_text()
    assert f'extern "C" int {symbol}(' in text
    assert replaces in text.replace("\n// ", "")
    assert "What bounds it on the H100" in text


def test_interop_round_trip():
    ctx = paper_context()
    rows, n_objects, n_attrs = to_numpy(ctx)
    back = context_from_arrays(rows, n_objects, n_attrs)
    assert back.rows.tobytes() == ctx.rows.tobytes() and back.n_attrs == ctx.n_attrs
    rows[0, 0] ^= 1  # a copy: the context does not alias the arrays
    assert back.rows.tobytes() == ctx.rows.tobytes()


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(CHIP_SMOKE, alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
