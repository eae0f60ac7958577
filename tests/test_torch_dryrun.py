"""The port's dry-run (``repro_torch.launch.specs``, ``dryrun_lib``,
``dryrun``) against the reference's ``repro.launch.specs`` and
``dryrun_lib``.

  * ``input_specs``: every arch × shape, the reference's
    ``ShapeDtypeStruct``s — inputs, labels, M-RoPE positions, the decode
    position and every cache leaf, a period-stacked reference leaf one
    leaf per layer in the port;
  * ``model_flops``: every arch × shape;
  * per-device parameter, optimizer-state and cache bytes: every arch on
    the production meshes 16 × 16 and 2 × 16 × 16 (the plan's FSDP and
    optimizer), against the reference's ``_sharded_bytes`` — whose
    ``partitioner.spec_for`` the reference's ``Partitioner`` lacks, so a
    fixture binds it to ``spec`` while this module runs;
  * the FCA cell on a fake 4 × 2 group against the reference's record on
    8 fake XLA devices (a subprocess, under the jax binding);
  * a reduced dense config's prefill and train cells against the real
    CPU step of the same model under ``op_analysis``;
  * full-width cells (published widths; depth cut to two layers, or one
    period, to keep the CPU time) traced on a fake 2 × 2 group,
    arctic-480b's train among them, and the CLI's exit codes;
  * the local forms the partitioned model takes on DTensors (no view,
    product or gather rule of DTensor's own, which differ between torch
    releases and refused the production mesh's uneven head splits) on 4
    gloo ranks: ``partition.reshape``, ``layers.linear``, the embedding
    lookup, a row-parallel output summed before the residual add and the
    RG-LRU gate's affine map, against the dense values and gradients,
    within 1e-5.

The dry-runs here trace fake CPU tensors (``device="cpu"``): autograd on
fake CUDA tensors needs a torch built with CUDA.  Each fake group is
started and destroyed by a fixture.  Tolerance: equality.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.configs import get_plan as ref_get_plan
from repro.configs import get_shape as ref_get_shape
from repro.dist.partition import Partitioner as RefPartitioner
from repro.launch import dryrun_lib as ref_dryrun
from repro.launch import specs as ref_specs
from repro.models import transformer as ref_tf
from repro.train import optim as ref_optim
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_plan
from repro_torch.dist.partition import Partitioner
from repro_torch.launch import dryrun, dryrun_lib, specs
from repro_torch.launch.op_analysis import analyze
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.train import step as tstep
from repro_torch.train.optim import get_optimizer, warmup_cosine

from test_torch_collectives import ROOT, run_ranks
from test_torch_partition import _ref_leaves

PROD_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}


@pytest.fixture(scope="module")
def spec_for_bound():
    """The reference's ``_sharded_bytes`` calls ``partitioner.spec_for``;
    its ``Partitioner`` has only ``spec``.  Bound while this module runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RefPartitioner, "spec_for", RefPartitioner.spec, raising=False)
        yield


@pytest.fixture
def fake_group():
    from repro_torch.launch.dryrun import start_fake_group

    yield start_fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _ref_cache_leaves(caches, cfg) -> dict:
    """``{layers.<i>.<field>: (shape, dtype)}`` of the reference's stacked
    caches, one entry a layer."""
    shapes = _ref_leaves(ref_tf.cache_axes(cfg), caches, cfg)
    dtypes = _ref_leaves(ref_tf.cache_axes(cfg), jax.tree_util.tree_map(
        lambda x: types.SimpleNamespace(shape=(str(x.dtype),)), caches), cfg)
    return {name: (shape[1:] if stacked else shape, dtypes[name][1][-1])
            for name, (_, shape, stacked) in shapes.items()}


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_references(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    want = ref_specs.input_specs(ref_get_config(arch), ref_get_shape(shape_name))
    got = specs.input_specs(cfg, shape)
    assert set(got) == set(want)
    for key, w in want.items():
        if key == "caches":
            continue
        assert got[key].device.type == "meta"
        assert (tuple(got[key].shape), _dtype(got[key])) == (tuple(w.shape), str(w.dtype)), key
    if "caches" in want:
        ref = _ref_cache_leaves(want["caches"], ref_get_config(arch))
        port = {f"layers.{i}.{f}": (tuple(getattr(c, f).shape), _dtype(getattr(c, f)))
                for i, c in enumerate(got["caches"]) for f in c._fields}
        assert port == ref


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_references(arch, shape_name):
    assert dryrun_lib.model_flops(get_config(arch), SHAPES[shape_name]) == \
        ref_dryrun.model_flops(ref_get_config(arch), ref_get_shape(shape_name))


@functools.cache
def _ref_bytes(arch: str, mesh: str) -> dict:
    cfg, plan = ref_get_config(arch), ref_get_plan(arch)
    part = RefPartitioner(types.SimpleNamespace(shape=PROD_MESHES[mesh]), fsdp=plan.fsdp)
    values, axes = ref_tf.abstract_params(cfg)
    opt = ref_optim.get_optimizer(plan.optimizer, ref_optim.warmup_cosine(3e-4, 100, 10_000))
    out = {"params": ref_dryrun._sharded_bytes(part, axes, values),
           "opt": ref_dryrun._sharded_bytes(part, opt.state_axes(axes),
                                            jax.eval_shape(opt.init, values))}
    for name in ("decode_32k", "long_500k"):
        s = ref_specs.decode_input_specs(cfg, ref_get_shape(name))
        out[name] = ref_dryrun._sharded_bytes(part, ref_tf.cache_axes(cfg), s["caches"])
    return out


@pytest.mark.parametrize("mesh", list(PROD_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharded_bytes_equal_the_references(arch, mesh, spec_for_bound):
    cfg, plan = get_config(arch), get_plan(arch)
    part = Partitioner(types.SimpleNamespace(shape=PROD_MESHES[mesh]), fsdp=plan.fsdp)
    model = Decoder(cfg, device="meta", seed=None)
    opt = get_optimizer(plan.optimizer, warmup_cosine(3e-4, 100, 10_000))
    got = {"params": dryrun_lib.param_bytes(part, model),
           "opt": dryrun_lib.optimizer_bytes(part, model, opt)}
    for name in ("decode_32k", "long_500k"):
        caches = specs.decode_input_specs(cfg, SHAPES[name])["caches"]
        got[name] = dryrun_lib.cache_bytes(part, cfg, caches)
    assert got == _ref_bytes(arch, mesh)
    assert got["params"] > 0 and got["opt"] > 0


_REF_FCA = """
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.core.axis_frame = lambda name: jax.lax.axis_size(name)
    from repro.launch.dryrun_lib import run_fca_cell
    from repro.launch.mesh import make_local_mesh
    mesh = make_local_mesh(data=4, model=2)
    print(json.dumps(run_fca_cell(mesh, "4x2", n_objects=1 << 14, n_attrs=512, batch=256)))
"""


def test_fca_cell_equals_the_references_record(fake_group):
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF_FCA)], env=ENV,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    from repro_torch.launch.mesh import make_local_mesh

    fake_group(8)
    mesh = make_local_mesh(data=4, model=2, device_type="cpu")
    got = dryrun_lib.run_fca_cell(mesh, "4x2", n_objects=1 << 14, n_attrs=512, batch=256,
                                  device="cpu")
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert want["status"] == got["status"] == "ok", (want, got)
    for key in ("arch", "shape", "mesh", "chips", "flops_per_device",
                "collective_bytes_per_device", "collective_by_kind",
                "context_bytes_per_device", "model_flops_global"):
        assert got[key] == want[key], key
    assert got["flops_per_device"] == 1_073_741_824
    assert got["collective_by_kind"] == {"all-to-all": 16384.0, "all-reduce": 1024.0,
                                         "all-gather": 16384.0}
    assert got["context_bytes_per_device"] == 131_072


def _reduced(kind: str):
    cfg = get_config("gemma2-9b").reduced()
    return cfg, ShapeConfig(f"reduced_{kind}", kind, 64, 2)


def test_prefill_cell_counts_a_real_cpu_prefill():
    cfg, shape = _reduced("prefill")
    rec = dryrun_lib.run_cell("gemma2-9b", shape.name, None, "1", device="cpu", cfg=cfg,
                              shape=shape)
    assert rec["status"] == "ok", rec
    model = Decoder(cfg, device="cpu", seed=0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 64), dtype=np.int32))
    caches = model.init_caches(2, 64)
    step = tstep.make_prefill_step(model)
    with torch.no_grad():
        (logits, _), t = analyze(step, dict(model.named_parameters()), ids, caches,
                                 memory=True)
    assert torch.isfinite(logits).all() and tuple(logits.shape) == (2, 1, cfg.vocab_size)
    assert rec["flops_per_device"] == t.flops > 0
    assert rec["hbm_bytes_per_device"] == t.hbm_bytes
    assert rec["n_ops"] == t.n_ops
    assert rec["memory_analysis"]["temp_bytes"] == t.peak_bytes
    assert rec["collective_bytes_per_device"] == 0 and rec["chips"] == 1


def test_train_cell_counts_a_real_cpu_train_step():
    cfg, shape = _reduced("train")
    rec = dryrun_lib.run_cell("gemma2-9b", shape.name, None, "1", device="cpu", cfg=cfg,
                              shape=shape)
    assert rec["status"] == "ok", rec
    model = Decoder(cfg, device="cpu", seed=0)
    opt = get_optimizer(get_plan("gemma2-9b").optimizer, warmup_cosine(3e-4, 100, 10_000))
    state = tstep.init_state(model, opt)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 64),
                                              dtype=np.int32)) for k in ("inputs", "labels")}
    (_, metrics), t = analyze(tstep.make_train_step(model, opt), state, batch, memory=True)
    assert np.isfinite(float(metrics["loss"]))
    assert rec["flops_per_device"] == t.flops > 0
    assert rec["hbm_bytes_per_device"] == t.hbm_bytes
    assert rec["memory_analysis"]["temp_bytes"] == t.peak_bytes
    nbytes = sum(x.numel() * x.element_size() for x in model.parameters())
    assert rec["state_bytes_per_device"] == 4 * nbytes + 4  # bf16-free: p, m, v, master, step


FULL_WIDTH = [("arctic-480b", "train_4k"), ("gemma2-9b", "prefill_32k"),
              ("qwen2-vl-72b", "decode_32k"), ("mamba2-370m", "long_500k"),
              ("recurrentgemma-2b", "train_4k")]


@pytest.mark.parametrize("arch,shape_name", FULL_WIDTH, ids=["-".join(c) for c in FULL_WIDTH])
def test_full_width_cells_trace_on_a_fake_2x2_group(arch, shape_name, fake_group):
    from repro_torch.launch.mesh import make_local_mesh

    fake_group(4)
    mesh = make_local_mesh(data=2, model=2, device_type="cpu")
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=max(2, full.period))
    rec = dryrun_lib.run_cell(arch, shape_name, mesh, "2x2", device="cpu", cfg=cfg)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 4 and rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"] > 0 and rec["unresolved_whiles"] == 0
    part = Partitioner(types.SimpleNamespace(shape={"data": 2, "model": 2}),
                       fsdp=get_plan(arch).fsdp)
    model = Decoder(cfg, device="meta", seed=None)
    want = dryrun_lib.param_bytes(part, model)
    if SHAPES[shape_name].kind == "train":
        want += dryrun_lib.optimizer_bytes(part, model, get_optimizer(
            get_plan(arch).optimizer, warmup_cosine(3e-4, 100, 10_000)))
    assert rec["state_bytes_per_device"] == want
    # the arguments are the placed state (and inputs): at least the state
    assert rec["memory_analysis"]["argument_bytes"] >= want


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          env=ENV, capture_output=True, text=True, timeout=300)


def test_cli_exit_codes(monkeypatch, capsys):
    r = _cli()
    assert r.returncode == 2 and "--arch and --shape required" in r.stderr
    r = _cli("--cell", "gemma2-9b")
    assert r.returncode == 2 and "--cell takes ARCH:SHAPE" in r.stderr
    r = _cli("--fca", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert (rec["status"], rec["chips"], rec["mesh"], rec["variant"]) == \
        ("ok", 256, "16x16", "optimized")
    assert rec["context_bytes_per_device"] == (1 << 23) * 128 * 4 // 256
    assert "# 1 cells: 1 ok, 0 skipped, 0 errors" in r.stderr
    if torch.version.cuda is None:
        r = _cli("--fca")
        assert r.returncode == 2 and "--device cpu" in r.stderr
    # a skipped cell, and a cell that errs, in this process (its fake group
    # of 256 ranks is the CLI's own, destroyed on the way out)
    assert dryrun.main(["--cell", "gemma2-9b:long_500k", "--cell", "codeqwen1.5-7b:long_500k",
                        "--device", "cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["arch"], r["status"]) for r in recs] == [("gemma2-9b", "skipped"),
                                                       ("codeqwen1.5-7b", "skipped")]
    monkeypatch.setattr(dryrun_lib, "run_cell", lambda *a, **kw: {
        "arch": a[0], "shape": a[1], "status": "error", "error": "RuntimeError: x"})
    assert dryrun.main(["--arch", "gemma2-9b", "--shape", "train_4k", "--device", "cpu"]) == 1
    assert "1 errors" in capsys.readouterr().err
    assert not dist.is_initialized()


LOCAL_FORMS = """
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Partial, Replicate, Shard, distribute_tensor
from repro_torch.dist.partition import reshape
from repro_torch.models.griffin import _affine
from repro_torch.models.layers import linear, summed
from repro_torch.models.transformer import _lookup

mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
out = {}


def check(name, fn, dense, *pls):
    g = torch.Generator().manual_seed(len(out))
    xs = [t.clone() for t in dense]
    for t in xs:
        if t.is_floating_point():
            t.requires_grad_(True)
    want = fn(*xs)
    w = torch.randn(want.shape, generator=g)
    (want * w).sum().backward()
    ds = [distribute_tensor(t.detach().clone().requires_grad_(t.is_floating_point()), mesh, pl)
          for t, pl in zip(dense, pls)]
    got = fn(*ds)
    (got * distribute_tensor(w, mesh, got.placements)).sum().backward()
    errs = [float((got.full_tensor() - want.detach()).abs().max())]
    errs += [float((d.grad.full_tensor() - t.grad).abs().max())
             for d, t in zip(ds, xs) if t.is_floating_point()]
    out[name] = [max(errs), [f"S{p.dim}" if isinstance(p, Shard) else
                             "P" if p.is_partial() else "R" for p in got.placements]]


torch.manual_seed(0)
R, S0, S2 = Replicate(), Shard(0), Shard(2)
check("split heads", lambda x: reshape(x, 4, 6, 8, 3), [torch.randn(4, 6, 24)], [S0, S2])
check("uneven heads", lambda x: reshape(x, 4, 6, 7, 2), [torch.randn(4, 6, 14)], [S0, S2])
check("merge heads", lambda x: reshape(x, 4, 6, 24), [torch.randn(4, 6, 8, 3)], [S0, S2])
check("inner shard", lambda x: reshape(x, 24, 10), [torch.randn(4, 6, 10)], [S0, Shard(1)])
check("column", linear, [torch.randn(4, 6, 8), torch.randn(8, 12)], [S0, R], [R, Shard(1)])
check("row", linear, [torch.randn(4, 6, 8), torch.randn(8, 12)], [S0, S2], [R, S0])
check("fsdp", linear, [torch.randn(4, 6, 8), torch.randn(8, 12)], [S0, R], [S0, Shard(1)])
check("seq", linear, [torch.randn(4, 6, 8), torch.randn(8, 12)], [S0, Shard(1)],
      [R, Shard(1)])
check("row summed", lambda x, w: summed(linear(x, w)),
      [torch.randn(4, 6, 8), torch.randn(8, 12)], [S0, S2], [R, S0])
check("gate affine", _affine, [torch.randn(4, 6, 8), torch.randn(8, 8), torch.randn(8)],
      [S0, S2], [R, S0], [R, S0])
ids = torch.randint(0, 10, (4, 6))
check("lookup", lambda t, i: _lookup(t, i), [torch.randn(10, 8), ids], [R, S0], [S0, R])
check("lookup fsdp", lambda t, i: _lookup(t, i), [torch.randn(10, 8), ids],
      [Shard(1), S0], [S0, R])
print(json.dumps(out))
"""


def test_local_forms_match_the_dense_ops_on_4_gloo_ranks(tmp_path):
    outs = run_ranks(tmp_path, LOCAL_FORMS, world=4)
    got = outs[0]
    assert all(o == got for o in outs)  # every rank holds the same whole values
    assert {k: v[0] <= 1e-5 for k, v in got.items()} == dict.fromkeys(got, True), got
    placements = {k: v[1] for k, v in got.items()}
    assert placements == {"split heads": ["S0", "S2"], "uneven heads": ["S0", "R"],
                          "merge heads": ["S0", "S2"], "inner shard": ["S0", "R"],
                          "column": ["S0", "S2"], "row": ["S0", "P"], "fsdp": ["S0", "S2"],
                          "row summed": ["S0", "R"], "gate affine": ["S0", "S2"],
                          "seq": ["S0", "S1"], "lookup": ["S0", "P"], "lookup fsdp": ["S0", "P"]}
