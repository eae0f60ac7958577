"""The port's partitioner (``repro_torch.dist.partition``) against the
reference's ``repro.dist.partition``, with no process group: the spec of
every leaf of every arch on shape-only meshes; K7's and K7b's plain
versions at a query offset (the rows one rank of the sequence-sharded
attention holds) against ``jax.vjp`` of the reference's
``blockwise_attention`` at the shifted query positions; ``launch/train
--mesh local`` on a one-rank gloo group.

Specs: for every arch of ``repro_torch.configs`` at full size (shapes only:
the port's model on the meta device, the reference's abstract tree), on
the meshes 1 x 1, 4 x 2, 2 x 4, 16 x 16 (data x model) and 2 x 16 x 16
(pod x data x model), with ``fsdp`` off and on, each parameter's, each
AdamW and Adafactor state leaf's, each cache leaf's and the batch's spec
equals the reference's ``Partitioner(SimpleNamespace(shape=...)).spec``
of the same leaf; a period-stacked reference leaf is one leaf per layer
in the port, whose spec is the reference's without its leading
``layers`` entry (Adafactor keeps the stacked leaves, and the entry).
Tolerance: equality.  Plain attention at q_off: float32 sums, 1e-5.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist.partition import Partitioner as RefPartitioner
from repro.models import attention as ref_attention
from repro.models import transformer as ref_tf
from repro.train import optim as ref_optim
from repro_torch.configs import ARCH_IDS, get_config, get_plan
from repro_torch.dist.partition import Partitioner, object_axes
from repro_torch.interop import axes_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer
from repro_torch.models.transformer import Decoder
from repro_torch.train import optim
from repro_torch.train.step import batch_shardings

from test_torch_collectives import ROOT

MESHES = {
    "1x1": {"data": 1, "model": 1},
    "4x2": {"data": 4, "model": 2},
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
CACHE_BATCH, CACHE_LEN = 32, 4096


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _ref_leaves(axes, values, cfg, per_layer: bool = True) -> dict:
    """The reference's (axes, shape) pairs → ``{port name: (axes, shape,
    stacked)}``: a period-stacked leaf per layer (``per_layer``) or under
    its ``layers/block{i}/...`` path (Adafactor's keys); the tail's layers
    and the top-level leaves under the port's names."""
    out = {}
    P = len(cfg.layer_pattern)

    def walk(ax, val, path):
        if _is_axes(ax):
            head = path[0]
            if head == "layers" and per_layer:
                for p in range(cfg.n_periods):
                    name = ".".join(["layers", str(P * p + int(path[1][5:])), *path[2:]])
                    out[name] = (ax, tuple(val.shape), True)
            elif head == "layers":
                out["/".join(path)] = (ax, tuple(val.shape), False)
            elif head == "tail":
                out[".".join(["layers", str(P * cfg.n_periods + int(path[1])), *path[2:]])] = (
                    ax, tuple(val.shape), False)
            else:
                out[".".join(path)] = (ax, tuple(val.shape), False)
            return
        if isinstance(ax, dict):
            for k in ax:
                walk(ax[k], val[k], path + [str(k)])
        elif hasattr(ax, "_fields"):
            for f in ax._fields:
                walk(getattr(ax, f), getattr(val, f), path + [f])
        else:
            for i, (a, v) in enumerate(zip(ax, val)):
                walk(a, v, path + [str(i)])

    walk(axes, values, [])
    return out


def _ref_spec(part, ax, shape, stacked) -> tuple:
    spec = tuple(part.spec(ax, shape))
    spec += (None,) * (len(shape) - len(spec))
    return spec[1:] if stacked else spec


@functools.cache
def _reference(arch: str):
    cfg = ref_get_config(arch)
    values, axes = ref_tf.abstract_params(cfg)
    caches = jax.eval_shape(lambda: ref_tf.init_caches(cfg, CACHE_BATCH, CACHE_LEN))
    opts = {}
    for name, opt in (("adamw", ref_optim.adamw(lambda s: 1e-3)),
                      ("adafactor", ref_optim.adafactor(lambda s: 1e-3))):
        state = jax.eval_shape(opt.init, values)
        opts[name] = (opt.state_axes(axes), state)
    return cfg, values, axes, caches, ref_tf.cache_axes(cfg), opts


@functools.cache
def _port(arch: str):
    cfg = get_config(arch)
    model = Decoder(cfg, device="meta", seed=None)
    params = dict(model.named_parameters())
    opts = {}
    for name in ("adamw", "adafactor"):
        opt = optim.get_optimizer(name, lambda s: 1e-3)
        opts[name] = (opt.state_axes(model.param_axes(), model.stacks()),
                      opt.init(params, model.stacks()))
    caches = model.init_caches(CACHE_BATCH, CACHE_LEN)
    return cfg, model, params, opts, caches


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_spec_equals_the_references(arch, mesh, fsdp):
    ref_cfg, values, axes, ref_caches, ref_cache_axes, ref_opts = _reference(arch)
    cfg, model, params, opts, caches = _port(arch)
    shape = MESHES[mesh]
    ref_part = RefPartitioner(types.SimpleNamespace(shape=shape), fsdp=fsdp)
    part = Partitioner(types.SimpleNamespace(shape=shape), fsdp=fsdp)
    assert object_axes(part.mesh) == tuple(a for a in ("pod", "data") if a in shape)

    # the parameters: the port's axes are the reference's, and so are the specs
    port_axes = model.param_axes()
    assert port_axes == axes_from_jax(axes, ref_cfg)
    ref = _ref_leaves(axes, values, ref_cfg)
    assert set(ref) == set(params)
    for name, p in params.items():
        ax, ref_shape, stacked = ref[name]
        assert part.spec(port_axes[name], p.shape) == _ref_spec(ref_part, ax, ref_shape,
                                                                stacked), name

    # the optimizer states
    for name, (ref_state_axes, ref_state) in ref_opts.items():
        state_axes, state = opts[name]
        assert state_axes["step"] == () and part.spec((), ()) == tuple(ref_part.spec((), ()))
        for key in (("m", "v", "master") if name == "adamw" else ("v",)):
            ref_l = _ref_leaves(ref_state_axes[key], ref_state[key], ref_cfg,
                                per_layer=name == "adamw")
            got = {}
            for leaf, ax in state_axes[key].items():
                if name == "adamw":
                    got[leaf] = part.spec(ax, state[key][leaf].shape)
                else:
                    for stat, sax in ax.items():
                        got[f"{leaf}.{stat}" if "/" not in leaf else f"{leaf}/{stat}"] = \
                            part.spec(sax, state[key][leaf][stat].shape)
            want = {}
            for leaf, (ax, ref_shape, stacked) in ref_l.items():
                want[leaf] = _ref_spec(ref_part, ax, ref_shape, stacked)
            assert got == want, (name, key)

    # the caches, layer by layer
    ref_c = _ref_leaves(ref_cache_axes, ref_caches, ref_cfg)
    for i, (cache, cax) in enumerate(zip(caches, transformer.cache_axes(cfg))):
        for field in cache._fields:
            ax, ref_shape, stacked = ref_c[f"layers.{i}.{field}"]
            assert part.spec(getattr(cax, field), getattr(cache, field).shape) == \
                _ref_spec(ref_part, ax, ref_shape, stacked), (i, field)

    # the batch (M-RoPE positions on dim 1)
    B, S = 256, 4096
    batch = {"inputs": torch.empty((B, S), device="meta"),
             "labels": torch.empty((B, S), device="meta"),
             "positions": torch.empty((3, B, S), device="meta")}
    sh = batch_shardings(part, batch)
    for key, dim in (("inputs", 0), ("labels", 0), ("positions", 1)):
        names = [None] * batch[key].dim()
        names[dim] = "batch"
        assert sh[key].placements == part.placements(
            tuple(ref_part.spec(names, tuple(batch[key].shape)))), key


# -- the plain attention at a query offset ------------------------------------

OFFSET_CASES = [  # window, cap, G, S (keys), hd, q_off, rows
    (None, None, 1, 40, 16, 20, 20),
    (None, 50.0, 2, 48, 16, 16, 16),
    (8, None, 3, 40, 8, 10, 30),
    (16, 30.0, 2, 64, 16, 32, 32),
    (None, None, 5, 33, 24, 11, 11),
]


@pytest.mark.parametrize("window,cap,G,T,hd,q_off,S", OFFSET_CASES)
def test_plain_attention_at_a_query_offset_matches_the_reference(window, cap, G, T, hd,
                                                                   q_off, S):
    """``attention_plain`` and ``attention_backward_plain`` on the query rows
    ``[q_off, q_off + S)`` of a T-key sequence (``blockwise_attention(...,
    q_off=)`` and ``attention_backward(..., q_off=)`` on the CPU) against
    the reference's ``blockwise_attention`` and its ``jax.vjp`` at query
    positions ``q_off + arange(S)``: out, dq, dk, dv within 1e-5."""
    rng = np.random.default_rng(29)
    B, KV = 2, 2
    q = rng.standard_normal((B, S, KV * G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KV, hd)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    qp, kp = jnp.arange(q_off, q_off + S, dtype=jnp.int32), jnp.arange(T, dtype=jnp.int32)
    out_ref, vjp = jax.vjp(lambda a, b, c: ref_attention.blockwise_attention(
        a, b, c, qp, kp, window=window, logit_cap=cap, kv_block=16),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = fa.blockwise_attention(tq, tk, tv, window=window, logit_cap=cap, q_off=q_off)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=1e-5, rtol=1e-5)
    got = fa.attention_backward(tq, tk, tv, out, None, torch.from_numpy(dout), window=window,
                                logit_cap=cap, q_off=q_off)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    plain = fa.attention_backward_plain(tq, tk, tv, torch.from_numpy(dout), window=window,
                                        logit_cap=cap,
                                        q_pos=torch.arange(q_off, q_off + S))
    for g, w in zip(plain, got):
        assert torch.equal(g, w)


def test_query_offset_with_valid_from_pads_rows_to_zero():
    """With left pads, a chunk's rows before ``valid_from`` are 0 and the
    rest equal the full sequence's rows (the plain version)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 24, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(np.float32))
            for _ in range(2))
    vf = torch.tensor([0, 15])
    full = fa.blockwise_attention(q, k, v, window=None, logit_cap=None, valid_from=vf)
    for lo in (0, 8, 16):
        chunk = fa.blockwise_attention(q[:, lo: lo + 8], k, v, window=None, logit_cap=None,
                                       valid_from=vf, q_off=lo)
        torch.testing.assert_close(chunk, full[:, lo: lo + 8], atol=0, rtol=0)
    assert bool((full[1, :15] == 0).all())
    with pytest.raises(ValueError):
        fa.blockwise_attention(q, k[:, :20], v[:, :20], window=None, logit_cap=None, q_off=1)


# -- launch/train on a one-rank group ------------------------------------------


def test_launch_train_mesh_local_trains_through_the_partitioner(tmp_path):
    """``--mesh local --device cpu --reduced`` starts a one-rank gloo group,
    trains on a 1 x 1 mesh through the partitioner (the arch plan's FSDP
    and optimizer) and prints the ``--mesh none`` run's ``done:`` line
    (a 1 x 1 mesh shards nothing: the same sums in the same order); a
    second run on the same ``--ckpt-dir`` restores the checkpoint onto
    the mesh and trains to the new ``--steps``."""
    def run(mesh, ckpt, steps):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama4-scout-17b-a16e",
             "--reduced", "--steps", str(steps), "--mesh", mesh, "--ckpt-dir", str(ckpt),
             "--ckpt-every", "2", "--device", "cpu"],
            capture_output=True, text=True, timeout=240, cwd=tmp_path,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "OMP_NUM_THREADS": "1", "HOME": str(tmp_path)})
        assert out.returncode == 0, out.stderr[-3000:]
        return [line for line in out.stdout.splitlines() if line.startswith("done:")][-1]

    local = run("local", tmp_path / "local", 3)
    assert local == run("none", tmp_path / "none", 3)
    assert run("local", tmp_path / "local", 4).startswith("done: steps=4 restarts=0")
    assert get_plan("llama4-scout-17b-a16e").fsdp
