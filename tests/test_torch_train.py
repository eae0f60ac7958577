"""The port's training path against the JAX package: ``lm_loss``,
``train_loss_fn`` and its gradients, K7b's plain version, the MoE drop
count under remat, the optimizers and the schedule, the train step, the
fault-tolerant trainer and ``launch/train``.

Inputs are made from numpy seeds and given to both packages (parameters
as ``interop.numpy_params`` trees, optimizer state through
``interop.opt_state_from_jax``).  Tolerances, with their reasons:

* loss within 2e-5 (float32: the sum order of the chunked cross-entropy
  and of the layers' reductions differs, ~1e-7 relative, nothing else);
* each gradient leaf within 1e-4 × its largest |g|: the backward sums in
  another order than XLA's transpose (each leaf a sum over B·S positions
  and, through the layers, over every later layer), and the online
  softmax's running maxima take another gradient path under autograd
  than under ``jax.grad`` (they cancel in exact arithmetic, not in
  float32); the worst leaf seen is ~1e-5 of its scale;
* optimizer updates over 5 steps within 1e-6 (the same float32 arithmetic
  in another fusion: a fused multiply-add where XLA rounds twice);
* the trainer's and the launcher's printed losses as the reference prints
  them (4 decimals).

On the CPU the attention's gradient is autograd through K7's plain version
(``attention_plain``); K7b itself runs on the card (chip_smoke.py phase
18).  The reference's gradients are computed once per arch and module.
"""

from __future__ import annotations

import io
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.lm_data import make_batch_iterator as ref_batch_iterator
from repro.launch import train as ref_train_cli
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.models.config import ShapeConfig as RefShapeConfig
from repro.train import optim as ref_optim
from repro_torch.configs import get_config
from repro_torch.data.lm_data import make_batch_iterator
from repro_torch.interop import (flatten_tree, numpy_params, opt_state_from_jax,
                                 params_from_jax)
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.train import optim
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.step import init_state, make_train_step

import _torch_reference  # noqa: F401,E402  (one torch thread per test process)

GRAD_ARCHS = ["gemma2-9b", "recurrentgemma-2b", "mamba2-370m", "llama4-scout-17b-a16e"]
LOSS_TOL = 2e-5
GRAD_REL = 1e-4
OPT_TOL = dict(atol=1e-6, rtol=1e-6)
B, S = 2, 32
SMOKE_SHAPE = ShapeConfig("smoke", "train", 32, 4)
_cache: dict = {}


def _batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"inputs": inputs,
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.rope_kind == "mrope":
        batch["positions"] = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    return batch


def _model(cfg, values) -> Decoder:
    m = Decoder(cfg, device="cpu", seed=None)
    m.load_state_dict(params_from_jax(values, cfg))
    return m


def _ref_grads(arch: str):
    """The reference's loss, metrics and gradients (numpy), once per arch."""
    if arch not in _cache:
        cfg = ref_get_config(arch).reduced()
        values = numpy_params(get_config(arch).reduced(), 0)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        fn = jax.jit(jax.value_and_grad(lambda p: ref_tf.train_loss_fn(p, cfg, batch),
                                        has_aux=True))
        (loss, metrics), grads = fn(jax.tree_util.tree_map(jnp.asarray, values))
        _cache[arch] = (values, float(loss), {k: float(v) for k, v in metrics.items()},
                        jax.tree_util.tree_map(np.asarray, grads))
    return _cache[arch]


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_chunk", [8, 12, 512])  # 4 chunks; 2 and a remainder; one
def test_lm_loss_matches_the_reference(seq_chunk):
    """Chunked cross-entropy (gemma2's tied embedding and final softcap) and
    its gradient with respect to the hidden states, with and without a
    remainder chunk."""
    cfg = get_config("gemma2-9b").reduced()
    rcfg = ref_get_config("gemma2-9b").reduced()
    values = numpy_params(cfg, 3)
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    rp = jax.tree_util.tree_map(jnp.asarray, values)
    want, want_g = jax.value_and_grad(
        lambda h: ref_tf.lm_loss(rp, rcfg, h, jnp.asarray(labels), seq_chunk=seq_chunk))(
        jnp.asarray(hidden))
    model = _model(cfg, values)
    h = torch.from_numpy(hidden).requires_grad_(True)
    got = transformer.lm_loss(model, h, torch.from_numpy(labels), seq_chunk=seq_chunk)
    (got_g,) = torch.autograd.grad(got, h)
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_TOL
    scale = float(np.abs(np.asarray(want_g)).max())
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=GRAD_REL * scale, rtol=0)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_train_loss_and_every_gradient_match_the_reference(arch):
    """``train_loss_fn`` (remat on, as in training) at B 2, S 32: the loss,
    ``xent`` and ``moe_aux`` within 2e-5, every parameter's gradient within
    1e-4 of its leaf's largest |g| (see the module docstring)."""
    values, want_loss, want_metrics, want_grads = _ref_grads(arch)
    cfg = get_config(arch).reduced()
    model = _model(cfg, values)
    params = model.trainable()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, metrics = transformer.train_loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss) - want_loss) <= LOSS_TOL
    for k in ("xent", "moe_aux"):
        assert abs(float(metrics[k]) - want_metrics[k]) <= LOSS_TOL, k
    want = params_from_jax(want_grads, cfg)
    assert set(want) == set(params)
    for (name, _), g in zip(params.items(), grads):
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_REL * max(scale, 1e-30), rtol=0,
                                   err_msg=name)


def test_remat_changes_no_gradient():
    """The layers recomputed in the backward (``torch.utils.checkpoint``)
    give the very gradients of the run that keeps every activation."""
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    model = _model(cfg, numpy_params(cfg, 0))
    params = model.trainable()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (True, False):
        hidden, _, aux = model.forward_hidden(batch["inputs"], mode="train", remat=remat)
        loss = transformer.lm_loss(model, hidden, batch["labels"]) + 0.01 * aux
        out.append(torch.autograd.grad(loss, list(params.values())))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# (window, cap, G, S, hd): the first four at S 40, hd 16; then the edges of
# K7b's bf16 tiles (S beside 64 and 128), the head dims it zero-pads (8,
# 24) and 64, G 1, 3 and 5, windows of 40 and 100 that end inside a 64-key
# tile, and the cap
K7B_PLAIN_CASES = [(None, None, 1, 40, 16), (5, None, 2, 40, 16), (None, 50.0, 4, 40, 16),
                   (7, 30.0, 2, 40, 16),
                   (None, None, 1, 63, 8), (40, None, 3, 64, 24), (None, 50.0, 5, 65, 64),
                   (100, 30.0, 3, 129, 64), (40, 50.0, 1, 129, 24), (None, None, 5, 64, 8),
                   (40, None, 1, 65, 64), (100, 50.0, 5, 129, 8)]


@pytest.mark.parametrize("window,cap,G,Sq,hd", K7B_PLAIN_CASES, ids=[
    f"{w}-{c}-{G}" + ("" if (S, hd) == (40, 16) else f"-S{S}-hd{hd}")
    for w, c, G, S, hd in K7B_PLAIN_CASES])
def test_attention_backward_plain_matches_the_references_gradient(window, cap, G, Sq, hd):
    """K7b's plain version (autograd through ``attention_plain``) against
    ``jax.vjp`` of the reference's ``blockwise_attention`` at the positions
    ``attn_full`` gives it: dq, dk and dv within 1e-5 (float32 sums).
    These are the gradients chip_smoke.py holds the kernel to on the card
    (phase 18)."""
    rng = np.random.default_rng(11)
    Bq, KV = 2, 2
    q = rng.standard_normal((Bq, Sq, KV * G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    pos = jnp.arange(Sq, dtype=jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: ref_attention.blockwise_attention(
        a, b, c, pos, pos, window=window, logit_cap=cap, kv_block=16), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = fa.blockwise_attention(tq, tk, tv, window=window, logit_cap=cap)
    got = fa.attention_backward(tq, tk, tv, out, None, torch.from_numpy(dout), window=window,
                                logit_cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def _cuda_functions(text: str) -> dict:
    """Each function defined in a CUDA source (``__global__`` or
    ``__device__``) → (is a kernel, its body)."""
    import re

    text = re.sub(r"__launch_bounds__\([^)]*\)", "", text)
    found = {}
    for m in re.finditer(r"\b(__global__|__device__)\b", text):
        paren = text.index("(", m.end())
        name = re.findall(r"(\w+)\s*$", text[m.end():paren])
        depth, i = 0, paren
        while True:  # the parameter list's closing parenthesis
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        rest = text[i + 1:].lstrip()
        if not name or not rest.startswith("{"):
            continue  # a declaration or a qualifier inside a body
        start = text.index("{", i)
        depth, j = 0, start
        while True:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            if depth == 0:
                break
            j += 1
        kernel = m.group(1) == "__global__"
        found[name[0]] = (found.get(name[0], (False, ""))[0] or kernel,
                          found.get(name[0], (False, ""))[1] + text[start:j + 1])
    return found


def test_every_wgmma_kernel_is_held_to_the_ptxas_rule():
    """Every ``__global__`` kernel of ``src/repro_torch/csrc`` whose body
    issues a ``wgmma`` product (itself or through the device functions it
    calls) is named in chip_smoke.py's ``PTXAS_BODIES``, whose
    instantiations must show no stack and no spills on the card; and no
    source includes ``<mma.h>`` (no WMMA body: K7b's bf16 passes are
    ``wgmma`` behind TMA rings)."""
    import re
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    csrc = root / "src" / "repro_torch" / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    funcs = {}
    for path in sources:
        text = path.read_text()
        assert not re.search(r"#include\s*<mma\.h>", text), path.name
        funcs.update(_cuda_functions(text))
    issues = {n for n, (_, body) in funcs.items() if "wgmma.mma_async" in body}
    while True:  # through the calls, to a fixed point
        more = {n for n, (_, body) in funcs.items() if n not in issues
                and any(re.search(rf"\b{c}\b", body) for c in issues)}
        if not more:
            break
        issues |= more
    kernels = {n for n in issues if funcs[n][0]}
    assert {"flash_fwd_wgmma_kernel", "bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel",
            "closure_tc_kernel"} <= kernels
    assert kernels <= set(cs.PTXAS_BODIES), kernels - set(cs.PTXAS_BODIES)


def test_blockwise_attention_with_grad_refuses_valid_from():
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="valid_from"):
        fa.blockwise_attention(q, k, k, window=None, logit_cap=None,
                               valid_from=torch.zeros(1, dtype=torch.int32))


def _ref_drops_patched(monkeypatch, cfg):
    """Patch the reference's ``moe_fwd`` (under ``jax.disable_jit``, so each
    layer's operands are concrete) to count each call's dropped
    assignments, from its own top-k decisions and capacity."""
    calls = []
    real = ref_moe.moe_fwd

    def counting(params, x, c, shard=None, exact=False):
        e = c.moe
        N = x.shape[0] * x.shape[1]
        xf = np.asarray(x, np.float32).reshape(N, -1)
        probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(params["router"], jnp.float32), -1)
        _, top_i = jax.lax.top_k(probs, e.top_k)
        counts = np.bincount(np.asarray(top_i).reshape(-1), minlength=e.n_experts)
        C = N * e.top_k if exact else max(1, int(round(N * e.top_k / e.n_experts
                                                       * e.capacity_factor)))
        calls.append(int(np.maximum(counts - C, 0).sum()))
        return real(params, x, c, shard, exact)

    monkeypatch.setattr(ref_tf.moe, "moe_fwd", counting)
    return calls


@pytest.mark.parametrize("arch", ["arctic-480b", "llama4-scout-17b-a16e"])
def test_moe_drops_count_each_train_forward_once(monkeypatch, arch):
    """A train step's forward and backward (every layer recomputed under
    remat) add each layer's dropped assignments to ``MoE.dropped`` once:
    the reference's drops for the same forward (at least one), layer by
    layer."""
    cfg = get_config(arch).reduced()
    rcfg = ref_get_config(arch).reduced()
    values = numpy_params(cfg, 5)
    # a router wide enough that the routing is uneven and capacity drops
    rng = np.random.default_rng(6)
    for tree in [values["layers"][f"block{i}"] for i in range(len(cfg.layer_pattern))] + \
            values.get("tail", []):
        tree["moe"]["router"] = rng.standard_normal(tree["moe"]["router"].shape).astype(
            np.float32)
    batch = _batch(cfg, seed=7)
    calls = _ref_drops_patched(monkeypatch, rcfg)
    with jax.disable_jit():
        ref_tf.forward_hidden(jax.tree_util.tree_map(jnp.asarray, values), rcfg,
                              jnp.asarray(batch["inputs"]), mode="train", remat=False)
    model = _model(cfg, values)
    params = model.trainable()
    loss, _ = transformer.train_loss_fn(model, {k: torch.from_numpy(v) for k, v in
                                                batch.items()})
    torch.autograd.grad(loss, list(params.values()))
    got = [int(m.dropped) for m in model.moe_layers()]
    # the reference scans period by period, so its calls run layer by layer
    assert len(calls) == cfg.n_layers
    assert got == calls, (got, calls)
    assert sum(got) > 0


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def test_warmup_cosine_matches_the_reference():
    """Within 1e-6 of the peak: near the cosine's end 1 + cos(π·frac)
    cancels, and the two float32 cosines differ in their last bit there."""
    peak = 3e-4
    ref, port = ref_optim.warmup_cosine(peak, 10, 50), optim.warmup_cosine(peak, 10, 50)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    got = np.array([float(port(torch.tensor(s))) for s in steps], dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * peak)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_the_reference(name):
    """Five updates of recurrentgemma-2b's reduced tree (scan-stacked
    periods and a tail) on seeded gradients: every parameter and every
    state leaf within 1e-6, from the reference's state carried across after
    the second step as well (``opt_state_from_jax``)."""
    cfg = get_config("recurrentgemma-2b").reduced()
    values = numpy_params(cfg, 8)
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), values) for _ in range(5)]
    lr = ref_optim.warmup_cosine(1e-2, 2, 5)
    ref = ref_optim.get_optimizer(name, lr)
    rp = jax.tree_util.tree_map(jnp.asarray, values)
    rstate = ref.init(rp)
    model = _model(cfg, values)
    params = model.trainable()
    opt = optim.get_optimizer(name, optim.warmup_cosine(1e-2, 2, 5))
    stacks = model.stacks()
    state = opt.init(params, stacks)
    for i, g in enumerate(grads):
        rp, rstate = ref.apply(jax.tree_util.tree_map(jnp.asarray, g), rstate, rp)
        with torch.no_grad():
            params, state = opt.apply(params_from_jax(g, cfg), state, params, stacks)
        want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, rp), cfg)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(), **OPT_TOL,
                                       err_msg=f"step {i + 1} {k}")
        want_s = flatten_tree(opt_state_from_jax(jax.tree_util.tree_map(np.asarray, rstate),
                                                 cfg))
        got_s = flatten_tree({k: v for k, v in state.items()})
        assert set(got_s) == set(want_s)
        for k, w in want_s.items():
            np.testing.assert_allclose(np.asarray(got_s[k]), np.asarray(w), **OPT_TOL,
                                       err_msg=f"step {i + 1} state {k}")
        if i == 1:  # carry the reference's state across and go on from it
            state = {k: v for k, v in opt_state_from_jax(
                jax.tree_util.tree_map(np.asarray, rstate), cfg).items()}


def _quadratic_problem():
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(16).astype(np.float32))
    return {"w": torch.zeros(16)}, lambda p: torch.sum((p["w"] - target) ** 2)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizers_converge_quadratic(opt_name):
    params, loss_fn = _quadratic_problem()
    # adafactor's RMS-normalized steps need a decaying lr to settle
    opt = optim.get_optimizer(opt_name, lambda step: 0.1 / torch.sqrt(step + 1.0))
    state = opt.init(params)
    for _ in range(300):
        p = {"w": params["w"].detach().requires_grad_(True)}
        (g,) = torch.autograd.grad(loss_fn(p), [p["w"]])
        params, state = opt.apply({"w": g}, state, params)
    assert float(loss_fn(params)) < 1e-2


def test_adamw_state_structure():
    params = {"w": torch.zeros(4, 8), "b": torch.zeros(8)}
    st = optim.adamw(lambda s: 1e-3).init(params)
    assert set(st) == {"step", "m", "v", "master"}
    for k in ("m", "v", "master"):
        assert set(st[k]) == set(params)
        assert all(st[k][n].dtype == torch.float32 for n in params)
    assert st["master"]["w"].data_ptr() != params["w"].data_ptr()


def test_adafactor_factored_shapes():
    params = {"w": torch.zeros(6, 4, 8), "b": torch.zeros(8)}
    st = optim.adafactor(lambda s: 1e-3).init(params)
    assert st["v"]["w"]["vr"].shape == (6, 4)
    assert st["v"]["w"]["vc"].shape == (6, 8)
    assert st["v"]["b"]["v"].shape == (8,)
    # a stacked group: one leaf over the periods, as the reference's scan
    st = optim.adafactor(lambda s: 1e-3).init({"a": torch.zeros(8), "c": torch.zeros(8)},
                                             {"layers/x": ["a", "c"]})
    assert set(st["v"]) == {"layers/x"}
    assert st["v"]["layers/x"]["vr"].shape == (2,) and st["v"]["layers/x"]["vc"].shape == (8,)


# ---------------------------------------------------------------------------
# Train step, trainer, launcher
# ---------------------------------------------------------------------------


def test_train_step_matches_the_reference_step():
    """One ``make_train_step`` step of gemma2-9b reduced (AdamW): the
    metrics within 2e-5 of the reference's ``make_train_step``, and the
    updated parameters within 1e-2 of the learning rate wherever the
    reference's gradient is at least 1e-6.  AdamW's first update is
    g / (|g| + 1e-8): where |g| is near that 1e-8 the update turns on the
    gradient's last float32 bits (the elements that differ here have |g|
    of 7e-9 to 1e-7), so there only the bound of one step holds: within
    2 (1 + 0.1 |p|) learning rates."""
    from repro.train.step import make_train_step as ref_make_train_step

    arch, lr = "gemma2-9b", 1e-3
    values, _, _, want_grads = _ref_grads(arch)
    cfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    batch = _batch(cfg)
    ref_opt = ref_optim.get_optimizer("adamw", ref_optim.warmup_cosine(lr, 1, 10))
    rp = jax.tree_util.tree_map(jnp.asarray, values)
    rstate, rmet = jax.jit(ref_make_train_step(rcfg, ref_opt, None))(
        {"params": rp, "opt": ref_opt.init(rp), "step": jnp.zeros((), jnp.int32)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = _model(cfg, values)
    opt = optim.get_optimizer("adamw", optim.warmup_cosine(lr, 1, 10))
    state, met = make_train_step(model, opt)(init_state(model, opt), batch)
    for k in ("loss", "xent", "moe_aux", "grad_norm"):
        assert abs(float(met[k]) - float(rmet[k])) <= LOSS_TOL * max(1.0, abs(float(rmet[k]))), k
    assert int(state["step"]) == 1 and int(state["opt"]["step"]) == 1
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, rstate["params"]), cfg)
    grads = params_from_jax(want_grads, cfg)
    init = params_from_jax(values, cfg)
    for k, p in state["params"].items():
        diff = (p.detach() - want[k]).abs()
        clear = grads[k].abs() >= 1e-6
        assert float(torch.where(clear, diff, 0.0).max()) <= 1e-2 * lr, k
        assert bool((diff <= 2 * lr * (1 + 0.1 * init[k].abs())).all()), k


def test_data_pipeline_matches_the_reference():
    cfg = get_config("mamba2-370m").reduced()
    rcfg = ref_get_config("mamba2-370m").reduced()
    shape = RefShapeConfig("smoke", "train", 32, 4)
    it1 = make_batch_iterator(cfg, SMOKE_SHAPE, seed=3, start_step=3)
    it2 = ref_batch_iterator(rcfg, shape, seed=3, start_step=3)
    for _ in range(2):
        (s1, b1), (s2, b2) = next(it1), next(it2)
        assert s1 == s2
        for k in b2:
            np.testing.assert_array_equal(b1[k], np.asarray(b2[k]))


def _tiny_trainer(tmp_path, total_steps=12, fault_hook=None, **kw):
    cfg = get_config("mamba2-370m").reduced()
    opt = optim.get_optimizer("adamw", optim.warmup_cosine(1e-2, 2, total_steps))
    model = Decoder(cfg, device="cpu", seed=None)

    def init():
        model.reset_parameters(0)
        return init_state(model, opt)

    return Trainer(
        step_fn=make_train_step(model, opt),
        init_state_fn=init,
        batch_iter_fn=lambda start: make_batch_iterator(cfg, SMOKE_SHAPE, seed=0,
                                                        start_step=start),
        cfg=TrainerConfig(total_steps=total_steps, ckpt_every=4, ckpt_dir=str(tmp_path),
                          max_retries=3, **kw),
        fault_hook=fault_hook,
    )


def test_trainer_runs_and_loss_decreases(tmp_path):
    out = _tiny_trainer(tmp_path, total_steps=15).run()
    hist = out["history"]
    assert out["steps"] == 15
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert {"loss", "xent", "moe_aux", "grad_norm", "step"} <= set(hist[0])


def test_trainer_restart_after_injected_fault(tmp_path):
    boom = {"armed": True}

    def fault_hook(step):
        if step == 9 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    out = _tiny_trainer(tmp_path, total_steps=12, fault_hook=fault_hook).run()
    assert out["steps"] == 12
    assert out["n_restarts"] == 1
    # resumed from the step-8 checkpoint and replayed deterministically
    steps_seen = [h["step"] for h in out["history"]]
    assert steps_seen.count(8) == 2


def test_trainer_restart_equals_uninterrupted(tmp_path):
    """Checkpoint/restart replays bit for bit: every step's metrics of a run
    with a fault at step 6 equal the uninterrupted run's."""
    out1 = _tiny_trainer(tmp_path / "a", total_steps=10).run()

    def fault_hook(step):
        if step == 6 and not getattr(fault_hook, "fired", False):
            fault_hook.fired = True
            raise RuntimeError("boom")

    out2 = _tiny_trainer(tmp_path / "b", total_steps=10, fault_hook=fault_hook).run()
    l1 = {h["step"]: h for h in out1["history"]}
    l2 = {h["step"]: h for h in out2["history"]}
    for s in range(10):
        assert l1[s] == l2[s], s


def test_trainer_gives_up_after_max_retries(tmp_path):
    """A step that fails every time (here the first: a success in between
    would reset the count) re-raises its error after max_retries restarts."""
    def fault_hook(step):
        if step == 0:
            raise ValueError("permanent failure")

    t = _tiny_trainer(tmp_path, total_steps=4, fault_hook=fault_hook)
    with pytest.raises(ValueError, match="permanent"):
        t.run()
    assert t.n_restarts == 4


def test_nan_guard_restarts(tmp_path):
    """A non-finite loss is a failure: the step is retried from the last
    checkpoint, and after max_retries the FloatingPointError surfaces."""
    t = _tiny_trainer(tmp_path, total_steps=3)
    real = t.step_fn

    def nan_step(state, batch):
        state, metrics = real(state, batch)
        return state, dict(metrics, loss=torch.tensor(float("nan")))

    t.step_fn = nan_step
    with pytest.raises(FloatingPointError, match="non-finite"):
        t.run()
    assert t.n_restarts == 4


def _done_line(main, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return next(line for line in buf.getvalue().splitlines() if line.startswith("done:"))


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-vl-72b"])  # AdamW; Adafactor, embeds
def test_launch_train_prints_the_reference_done_line(monkeypatch, tmp_path, arch):
    """``--reduced --steps 4 --mesh none`` on the same weights (the
    reference's init replaced by the numpy tree the port loads with
    ``--weights``): the reference's ``done:`` line, its losses to the last
    printed digit."""
    cfg = get_config(arch).reduced()
    values = numpy_params(cfg, 12)
    monkeypatch.setattr(ref_train_cli.transformer, "init_params",
                        lambda c, seed=0: (jax.tree_util.tree_map(jnp.asarray, values), None))
    want = _done_line(ref_train_cli.main, ["--arch", arch, "--reduced", "--steps", "4",
                                           "--mesh", "none", "--ckpt-dir",
                                           str(tmp_path / "ref")])
    npz = tmp_path / "w.npz"
    np.savez(npz, **flatten_tree(values))
    got = _done_line(train_cli.main, ["--arch", arch, "--reduced", "--steps", "4", "--mesh",
                                      "none", "--ckpt-dir", str(tmp_path / "port"),
                                      "--weights", str(npz), "--device", "cpu"])
    pattern = r"done: steps=(\d+) restarts=(\d+) loss (\d+\.\d{4}) → (\d+\.\d{4})"
    g, w = re.fullmatch(pattern, got), re.fullmatch(pattern, want)
    assert g and w and g.group(1, 2) == w.group(1, 2) == ("4", "0")
    # the losses agree within 1e-5; printed to 4 decimals, two such numbers
    # may round one unit apart
    for i in (3, 4):
        assert abs(float(g.group(i)) - float(w.group(i))) <= 1e-4 + 1e-9, (got, want)


@pytest.mark.parametrize("mesh", ["production", "multi-pod"])
def test_launch_train_refuses_a_production_mesh(mesh, tmp_path):
    """The production meshes (16 x 16, 2 x 16 x 16) need 256 / 512 ranks:
    on the one-rank group the launcher starts it raises, as the
    reference's raises on too few devices, and leaves no group behind."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="production mesh"):
        train_cli.main(["--arch", "gemma2-9b", "--reduced", "--steps", "1", "--mesh", mesh,
                        "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert not dist.is_initialized()


def test_chip_smoke_train_reduced_losses_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 19 (every config reduced, 3 steps through the
    Trainer with the plan's optimizer) run on the CPU: each step's loss
    within TRAIN_LOSS_TOL of the reference's pinned losses
    (TRAIN_REDUCED_EXPECTED, from ``tests/_torch_reference.py train``)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    from repro_torch.configs import ARCH_IDS

    assert set(cs.TRAIN_REDUCED_EXPECTED) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        rec = cs.train_reduced(arch, "cpu", str(tmp_path / arch))
        want = cs.TRAIN_REDUCED_EXPECTED[arch]
        assert rec["steps"] == cs.TRAIN_REDUCED_STEPS and rec["restarts"] == 0
        np.testing.assert_allclose(rec["losses"], want, atol=cs.TRAIN_LOSS_TOL, rtol=0,
                                   err_msg=arch)
