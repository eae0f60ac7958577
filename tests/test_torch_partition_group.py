"""The partitioner on real process groups: 4 gloo ranks on the CPU, at
float32, against the JAX package.

* **EP**: arctic-480b ``reduced()`` with 8 experts, on 2 x 2 and 1 x 4
  (data x model), at the config's capacity factor (1.25: drops, per data
  shard) and at 8.0 (none): ``moe_fwd``'s expert-parallel path against the
  reference's ``_moe_ep_shardmap`` on the same mesh shape (a subprocess
  with 8 fake XLA devices) within 1e-4 (the reference's own tolerance for
  it), and its drop count against a numpy count over the same routing and
  per-shard capacity (the reference counts none).
* **Sharded train steps** on 2 x 2 with ``fsdp=True``: mamba2-370m (the
  reference's own case) and gemma2-9b at chip_smoke.py's phase-19 setting,
  against the reference's single-device losses (``TRAIN_REDUCED_EXPECTED``),
  and llama4-scout (MoE, expert-parallel) at capacity factor 8.0 (no drops,
  so the per-shard capacity changes nothing) against the reference's
  single-device run on the same weights: 3 steps within 2e-5.

The seq_model path, partitioned serving and the elastic restore are in
``tests/test_torch_partition_serve.py``, which shares this file's rank
prelude.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.interop import numpy_params

from test_torch_collectives import ROOT, run_ranks

sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

EP_CASES = [((2, 2), 1.25), ((2, 2), 8.0), ((1, 4), 1.25), ((1, 4), 8.0)]
EP_X = (8, 16)  # B, S
MOE_TRAIN_CF = 8.0
SERVE_ARCHS = ("gemma2-9b", "recurrentgemma-2b", "mamba2-370m")
SERVE_NEW = 6  # the first 6 of the reference's 16 greedy tokens


def _ep_cfg(cf: float):
    cfg = get_config("arctic-480b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8,
                                                            capacity_factor=cf))


REFERENCE = """
import os, sys, dataclasses, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, get_plan
from repro.data.lm_data import make_batch_iterator
from repro.dist.partition import Partitioner
from repro.models import moe
from repro.models.config import ShapeConfig
from repro.train import step as tstep
from repro.train.optim import get_optimizer, warmup_cosine
from repro_torch.interop import numpy_params

inp = np.load("inputs.npz")
c = json.load(open("cfg.json"))
out = {}
for key, (shape, cf) in c["ep"].items():
    cfg = get_config("arctic-480b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8,
                                                           capacity_factor=cf))
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:4])
    p = {k: jnp.asarray(inp["moe_" + k]) for k in ("router", "w_gate", "w_up", "w_down")}
    y, _ = jax.jit(lambda p_, x_: moe.moe_fwd(p_, x_, cfg, shard=Partitioner(mesh),
                                             exact=False))(p, jnp.asarray(inp["x"]))
    out[key] = np.asarray(y)
arch = "llama4-scout-17b-a16e"
cfg = get_config(arch).reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=c["moe_cf"]))
values = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, c["seed"]))
opt = get_optimizer(get_plan(arch).optimizer, warmup_cosine(c["lr"], c["warmup"], c["steps"]))
state = {"params": values, "opt": opt.init(values), "step": jnp.zeros((), jnp.int32)}
step = jax.jit(tstep.make_train_step(cfg, opt, None))
it = make_batch_iterator(cfg, ShapeConfig("reduced", "train", *c["shape"]), seed=0)
losses = []
for _ in range(c["steps"]):
    _, batch = next(it)
    state, m = step(state, batch)
    losses.append(float(m["loss"]))
out["moe_losses"] = np.asarray(losses)
np.savez("ref.npz", **out)
"""

PRELUDE = """
import dataclasses, os
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_plan
from repro_torch.data.lm_data import make_batch_iterator
from repro_torch.dist.partition import Partitioner, distribute, replicate_plain
from repro_torch.interop import numpy_params, params_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention as attn_mod, moe
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import step as tstep
from repro_torch.train.optim import get_optimizer, warmup_cosine

cfg_in = json.load(open("cfg.json"))


def pl(placements):
    return ["S%d" % p.dim if isinstance(p, Shard) else type(p).__name__[0] for p in placements]


meshes = {"2x2": make_local_mesh(model=2), "1x4": make_local_mesh(data=1, model=4),
          "4x1": make_local_mesh(data=4, model=1)}
out = {"rank": rank}

import time
t_last = time.perf_counter()
def lap(name):
    global t_last
    out.setdefault("seconds", {})[name] = time.perf_counter() - t_last
    t_last = time.perf_counter()

def train(cfg, arch, mesh_name, steps):
    plan = get_plan(arch)
    part = Partitioner(meshes[mesh_name], fsdp=True)
    opt = get_optimizer(plan.optimizer, warmup_cosine(cfg_in["lr"], cfg_in["warmup"],
                                                      cfg_in["steps"]))
    model = Decoder(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(numpy_params(cfg, cfg_in["seed"]), cfg))
    sh = tstep.model_state_shardings(part, model, opt)
    tstep.shard_model(model, part)
    state = tstep.init_state(model, opt, sh)
    step = tstep.make_train_step(model, opt, part)
    it = make_batch_iterator(cfg, ShapeConfig("reduced", "train", *cfg_in["shape"]), seed=0)
    losses = []
    for _ in range(steps):
        _, batch = next(it)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, model, state, sh

"""

BODY = PRELUDE + """
# EP
inp = np.load("inputs.npz")
for key, (shape, cf) in cfg_in["ep"].items():
    cfg = get_config("arctic-480b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=8,
                                                           capacity_factor=cf))
    part = Partitioner(meshes[f"{shape[0]}x{shape[1]}"])
    m = moe.MoE(cfg, torch.float32, "cpu")
    for name in moe.MoE.AXES:
        t = torch.from_numpy(inp["moe_" + name])
        setattr(m, name, nn.Parameter(distribute(t, part.sharding(moe.MoE.AXES[name], t.shape)),
                                      requires_grad=False))
    x = torch.from_numpy(inp["x"])
    x = distribute(x, part.batch_spec(x.shape))
    assert moe._expert_parallel(part, cfg, False)
    with torch.no_grad(), replicate_plain():
        y, aux, dropped = moe.moe_fwd(m, x, cfg, shard=part)
        y = y.full_tensor()
        dropped = int(dropped.full_tensor())
    if rank == 0:
        np.save(f"{key}.npy", y.numpy())
    out[key] = {"dropped": dropped, "placements": pl(m.w_gate.placements)}

lap("ep")

# layers.local_product (the out_dtype products' rule) on every placement of
# two operands over 2 x 2, a float32 mm / bmm standing in for the card's
# out_dtype products: the result and both gradients against the dense ones
from itertools import product as combos
from torch.distributed.tensor import Partial
from repro_torch.models.layers import local_product
mesh = meshes["2x2"].device_mesh
gen = torch.Generator().manual_seed(3)
lp = {"cases": 0, "max_err": 0.0}
for nd, fn in ((2, torch.mm), (3, torch.bmm)):
    a = torch.randn((4, 8, 12)[3 - nd:], generator=gen)
    b = torch.randn((4, 12, 8)[3 - nd:], generator=gen)
    g = torch.randn((4, 8, 8)[3 - nd:], generator=gen)
    want = fn(a, b)
    want_ga, want_gb = g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g
    opts = [Replicate()] + [Shard(d) for d in range(nd)]
    for pa in combos(opts, repeat=2):
        for pb in combos(opts, repeat=2):
            da = distribute(a, type(part.sharding((), ()))(mesh, pa)).detach().requires_grad_(True)
            db = distribute(b, type(part.sharding((), ()))(mesh, pb)).detach().requires_grad_(True)
            got = local_product(fn, da, db)
            ga, gb = torch.autograd.grad(got, (da, db), distribute(
                g, type(part.sharding((), ()))(mesh, got.placements)))
            for x, w in ((got, want), (ga, want_ga), (gb, want_gb)):
                lp["max_err"] = max(lp["max_err"], float((x.full_tensor() - w).abs().max()))
            lp["cases"] += 1
out["local_product"] = lp
lap("local_product")

# sharded train steps on 2 x 2 (FSDP)
for arch in ("mamba2-370m", "gemma2-9b"):
    out["train_" + arch] = train(get_config(arch).reduced(), arch, "2x2", cfg_in["steps"])[0]
moe_cfg = get_config("llama4-scout-17b-a16e").reduced()
moe_cfg = dataclasses.replace(moe_cfg, moe=dataclasses.replace(moe_cfg.moe,
                                                               capacity_factor=cfg_in["moe_cf"]))
out["train_moe"] = train(moe_cfg, "llama4-scout-17b-a16e", "2x2", cfg_in["steps"])[0]
lap("train")

print(json.dumps(out))
"""




def write_config(tmp) -> None:
    """The run's settings, read by the ranks (and the reference) from ``cfg.json``."""
    serve = SERVE_ARCHS
    (tmp / "cfg.json").write_text(json.dumps({
        "ep": {f"ep_{s[0]}x{s[1]}_{cf}": (s, cf) for s, cf in EP_CASES},
        "lr": cs.TRAIN_LR, "warmup": cs.TRAIN_WARMUP, "steps": cs.TRAIN_REDUCED_STEPS,
        "shape": list(cs.TRAIN_REDUCED_SHAPE), "seed": cs.LM_SEED, "moe_cf": MOE_TRAIN_CF,
        "serve": serve, "max_len": cs.LM_REDUCED_MAX_LEN, "max_new": SERVE_NEW,
        "prompts": {a: cs.lm_prompts_for(a, get_config(a).reduced().vocab_size)
                    for a in serve}}))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition_group")
    rng = np.random.default_rng(17)
    cfg = _ep_cfg(1.25)
    tree = numpy_params(cfg, 5)
    moe_tree = {k: np.ascontiguousarray(v[0]) for k, v in tree["layers"]["block0"]["moe"].items()
                if k != "shared"}
    x = rng.standard_normal((*EP_X, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "inputs.npz", x=x, **{f"moe_{k}": v for k, v in moe_tree.items()})
    write_config(tmp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE)], cwd=tmp, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        outs = run_ranks(tmp, BODY, world=4, timeout=300)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    with np.load(tmp / "ref.npz") as f:
        reference = dict(f)
    with np.load(tmp / "inputs.npz") as f:
        inputs = dict(f)
    return {"ranks": outs, "ref": reference, "tmp": tmp, "inputs": inputs}


def _numpy_drops(inp: dict, cfg, dp: int) -> int:
    """The drops of the port's routing rule (softmax in float32, top-k with
    ties to the lower id) at capacity round(N_loc k / E cf) per data shard."""
    e = cfg.moe
    xf = inp["x"].reshape(-1, cfg.d_model)
    logits = xf.astype(np.float32) @ inp["moe_router"].astype(np.float32)
    top = np.argsort(-logits, axis=-1, kind="stable")[:, : e.top_k]
    n_loc = xf.shape[0] // dp
    C = max(1, int(round(n_loc * e.top_k / e.n_experts * e.capacity_factor)))
    drops = 0
    for c in range(dp):
        counts = np.bincount(top[c * n_loc:(c + 1) * n_loc].reshape(-1), minlength=e.n_experts)
        drops += int(np.maximum(counts - C, 0).sum())
    return drops


@pytest.mark.parametrize("shape,cf", EP_CASES, ids=[f"{s[0]}x{s[1]}-cf{cf}" for s, cf in EP_CASES])
def test_expert_parallel_moe_matches_the_references(results, shape, cf):
    key = f"ep_{shape[0]}x{shape[1]}_{cf}"
    got = np.load(results["tmp"] / f"{key}.npy")
    np.testing.assert_allclose(got, results["ref"][key], atol=1e-4, rtol=0)
    drops = {r[key]["dropped"] for r in results["ranks"]}
    want = _numpy_drops(results["inputs"], _ep_cfg(cf), shape[0])
    assert drops == {want}
    assert (want > 0) == (cf < 2), want
    assert results["ranks"][0][key]["placements"] == ["R", "S0"]  # experts over model


def test_local_product_matches_the_dense_product_and_gradients(results):
    """``layers.local_product`` (the rule the card's ``out_dtype`` products
    take under a mesh) on every pair of placements of its operands over
    2 x 2: the product and both gradients within 1e-5 of the dense ones."""
    for r in results["ranks"]:
        assert r["local_product"]["cases"] == 9 * 9 + 16 * 16
        assert r["local_product"]["max_err"] <= 1e-5


@pytest.mark.parametrize("arch", ["mamba2-370m", "gemma2-9b", "moe"])
def test_sharded_train_steps_match_the_references_losses(results, arch):
    want = (results["ref"]["moe_losses"] if arch == "moe"
            else np.asarray(cs.TRAIN_REDUCED_EXPECTED[arch]))
    for r in results["ranks"]:
        np.testing.assert_allclose(r["train_" + arch], want, atol=2e-5, rtol=0)
