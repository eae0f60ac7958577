"""The port's other LM families against the JAX package: Griffin recurrence
(recurrentgemma-2b), Mamba-2 SSD (mamba2-370m), mixture-of-experts
(arctic-480b, llama4-scout-17b-a16e) and embedding inputs (qwen2-vl-72b,
musicgen-large).

Each arch runs ``reduced()`` at float32 on the reference's parameters
(``transformer.init_params(cfg, seed=0)``, numpy leaves) carried by
``interop.params_from_jax``; the same inputs go through both packages.
Held within 2e-5 (absolute and relative: sum order only): the full
forward's logits; prefill with left pads and a prompt past the reduced
window (32), then decode steps, and every cache leaf (KV caches on their
real slots, positions exactly; Griffin's and SSD's conv and state leaves
whole).  Exact: the greedy tokens of ``ServeEngine.generate`` and the
CLI's printed lines.  Also: the embeds path (the ``lm_data`` stub's
embeddings and M-RoPE streams ``[3, B, S]``), the deterministic value
leaves of the port's own init, every config's state dict against the
reference's tree, and mamba2's refusal of a prefill length that is not a
multiple of its chunk.  The reference's runs are cached per module.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import lm_data as ref_lm_data
from repro.launch import serve as ref_serve_cli
from repro.models import transformer as ref_tf
from repro.models.config import ShapeConfig as RefShapeConfig
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import lm_data
from repro_torch.interop import flatten_tree, params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import griffin, ssm
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.engine import left_pad

import _torch_reference  # noqa: F401,E402  (one torch thread per test process)

ARCHS = ["recurrentgemma-2b", "mamba2-370m", "arctic-480b", "llama4-scout-17b-a16e",
         "qwen2-vl-72b", "musicgen-large"]
TOL = dict(atol=2e-5, rtol=2e-5)
_cache: dict = {}
# the reference's forward, prefill and decode, each compiled once per config
# and shape (eager dispatch of the scanned layers is several times slower)
_ref_forward = jax.jit(ref_tf.forward_hidden, static_argnums=(1,), static_argnames=("mode",))
_ref_prefill = jax.jit(ref_tf.prefill, static_argnums=(1,))
_ref_decode = jax.jit(ref_tf.decode_step, static_argnums=(1,))


def _models(arch: str):
    """(config, reference config, reference values with numpy leaves, port
    Decoder on the CPU)."""
    if arch not in _cache:
        cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
        values, _ = ref_tf.init_params(ref_cfg, seed=0)
        values = jax.tree_util.tree_map(np.asarray, values)
        model = Decoder(cfg, device="cpu", seed=None)
        model.load_state_dict(params_from_jax(values, cfg))
        _cache[arch] = (cfg, ref_cfg, values, model)
    return _cache[arch]


def _long(arch: str, n: int) -> int:
    """A long prompt's length: mamba2's reduced chunk is 32, and a prefill
    longer than one chunk must be a whole number of chunks."""
    return -(-n // 32) * 32 if arch == "mamba2-370m" else n


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]


def _ref_layer_caches(cfg, ref_caches) -> list:
    """The reference's stacked + tail caches as one list, layer by layer,
    with numpy leaves."""
    out = []
    for p in range(cfg.n_periods):
        for i in range(len(cfg.layer_pattern)):
            out.append(jax.tree_util.tree_map(lambda a, p=p: np.asarray(a)[p],
                                              ref_caches["layers"][f"block{i}"]))
    return out + [jax.tree_util.tree_map(np.asarray, c) for c in ref_caches.get("tail", [])]


def _check_caches(cfg, caches, ref_caches):
    want_all = _ref_layer_caches(cfg, ref_caches)
    assert len(caches) == len(want_all) == cfg.n_layers
    for kind, got, want in zip(cfg.layer_pattern * cfg.n_periods + cfg.tail_pattern, caches,
                               want_all):
        if kind.startswith("attn"):
            assert isinstance(got, KVCache)
            np.testing.assert_array_equal(got.pos.numpy(), want.pos)
            real = want.pos >= 0
            np.testing.assert_allclose(got.k.numpy()[real], want.k[real], **TOL)
            np.testing.assert_allclose(got.v.numpy()[real], want.v[real], **TOL)
        else:
            assert isinstance(got, griffin.RecCache if kind == "rec" else ssm.SSMCache)
            assert got.h.dtype == torch.float32
            for g, w in zip(got, want):
                assert tuple(g.shape) == w.shape
                np.testing.assert_allclose(g.numpy(), w, **TOL)


# -- the decoder ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_with_the_references_tree(arch):
    """``Decoder`` builds for all ten configs, and its state dict is the
    reference's parameter tree leaf for leaf (names, shapes, dtypes)."""
    ref_cfg = ref_get_config(arch).reduced()
    shapes = jax.eval_shape(lambda: ref_tf.init_params(ref_cfg, seed=0)[0])
    want = {k: (tuple(v.shape), v.dtype) for k, v in params_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
        get_config(arch).reduced()).items()}
    model = Decoder(get_config(arch).reduced(), device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_full_forward_matches_the_reference(arch):
    cfg, ref_cfg, values, model = _models(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    hidden, _, aux = _ref_forward(values, ref_cfg, jnp.asarray(toks), mode="train")
    want = ref_tf.logits_for(values, ref_cfg, hidden)
    with torch.inference_mode():
        got_h, caches, got_aux = model.forward_hidden(torch.from_numpy(toks), mode="train")
        got = model.logits_for(got_h)
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(aux), **TOL)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Left-padded prompts, the longest past the reduced window (32), then
    decode steps: logits and every cache leaf after each phase."""
    cfg, ref_cfg, values, model = _models(arch)
    toks, vf = left_pad(_prompts(cfg, [_long(arch, 41), 17, 1], seed=3), 3)
    B, max_len = toks.shape[0], 96
    ref_caches = ref_tf.init_caches(ref_cfg, B, max_len)
    want, ref_caches = _ref_prefill(values, ref_cfg, jnp.asarray(toks), ref_caches,
                                      valid_from=jnp.asarray(vf))
    with torch.inference_mode():
        caches = model.init_caches(B, max_len)
        got, caches = model.prefill(torch.from_numpy(toks), caches, torch.from_numpy(vf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_caches(cfg, caches, ref_caches)

    tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    t = toks.shape[1]
    for step in range(6):
        want, ref_caches = _ref_decode(values, ref_cfg, jnp.asarray(tok[:, None]),
                                              t + step, ref_caches)
        with torch.inference_mode():
            got, caches = model.decode_step(torch.from_numpy(tok[:, None]), t + step, caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    _check_caches(cfg, caches, ref_caches)


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-72b"])
def test_embeds_inputs_match_the_reference(arch):
    """The ``lm_data`` stub's embeddings [B, S, d] (and, for qwen2-vl, its
    M-RoPE streams [3, B, S]) through the full forward, a prefill and one
    decode step fed an embedding [B, 1, d]; the port's ``lm_data`` gives the
    reference's batches."""
    cfg, ref_cfg, values, model = _models(arch)
    shape = ShapeConfig("embeds", "train", 24, 2)
    _, batch = next(lm_data.make_batch_iterator(cfg, shape, seed=7))
    _, ref_batch = next(ref_lm_data.make_batch_iterator(
        ref_cfg, RefShapeConfig("embeds", "train", 24, 2), seed=7))
    assert batch.keys() == ref_batch.keys()
    for key in batch:
        np.testing.assert_array_equal(batch[key], ref_batch[key])
    x = batch["inputs"]
    assert x.shape == (2, 24, cfg.d_model) and x.dtype == np.float32
    pos = batch.get("positions")
    assert (pos is not None) == (cfg.rope_kind == "mrope")
    if pos is not None:
        assert pos.shape == (3, 2, 24)
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = None if pos is None else torch.from_numpy(pos)

    hidden, _, _ = _ref_forward(values, ref_cfg, jnp.asarray(x), mode="train",
                                         rope_positions=jpos)
    with torch.inference_mode():
        got, _, _ = model.forward_hidden(torch.from_numpy(x), mode="train", rope_positions=tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(hidden), **TOL)

    ref_caches = ref_tf.init_caches(ref_cfg, 2, 32)
    want, ref_caches = _ref_prefill(values, ref_cfg, jnp.asarray(x), ref_caches,
                                      rope_positions=jpos)
    step = np.random.default_rng(8).standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want2, _ = _ref_decode(values, ref_cfg, jnp.asarray(step), 24, ref_caches)
    with torch.inference_mode():
        caches = model.init_caches(2, 32)
        got, caches = model.prefill(torch.from_numpy(x), caches, rope_positions=tpos)
        got2, _ = model.decode_step(torch.from_numpy(step), 24, caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)


# -- the serving engine and the CLI --------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference_greedy_tokens(arch):
    cfg, ref_cfg, values, model = _models(arch)
    ref = RefServeEngine(ref_cfg, values, RefServeConfig(max_len=96, batch_slots=4))
    port = ServeEngine(cfg, model, ServeConfig(max_len=96, batch_slots=4), device="cpu")
    prompts = _prompts(cfg, [_long(arch, 40), 3, 9], seed=6)
    kernels.reset_launches()
    got = port.generate(prompts, max_new=10)
    assert got == ref.generate(prompts, max_new=10)
    assert [len(o) for o in got] == [10] * 3
    assert kernels.flash_attention.blockwise_attention.launches == 0  # CPU: plain versions


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_prints_what_the_reference_cli_prints(capsys, tmp_path, arch):
    argv = ["--arch", arch, "--reduced", "--prompts", "1,2,3;4,5,6,7;300,7", "--max-new", "6"]
    ref_serve_cli.main(argv)
    want = capsys.readouterr().out
    _, _, values, _ = _models(arch)
    path = tmp_path / "weights.npz"
    np.savez(path, **flatten_tree(values))
    serve_cli.main(argv + ["--weights", str(path), "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 3 and "→" in got


# -- init and limits --------------------------------------------------------------------


@pytest.mark.parametrize("arch,leaves", [("recurrentgemma-2b", ("lam",)),
                                         ("mamba2-370m", ("A_log", "D", "dt_bias"))])
def test_value_leaves_equal_the_references_init(arch, leaves):
    """The port's own init computes the reference's deterministic leaves
    (Griffin's Λ, SSD's A_log, D, dt_bias) by the reference's formulas:
    equal within float32 rounding (XLA and torch round linspace, log and
    expm1 a last bit apart, which Griffin's log(expm1(−log a / 8)) grows to
    ~3e-6 relative); bit for bit once in bfloat16, the full-width configs'
    dtype."""
    cfg, ref_cfg, values, _ = _models(arch)
    state = Decoder(cfg, device="cpu", seed=1).state_dict()
    state16 = Decoder(dataclasses.replace(cfg, dtype="bfloat16"), device="cpu",
                      seed=1).state_dict()
    ref16, _ = ref_tf.init_params(dataclasses.replace(ref_cfg, dtype="bfloat16"), seed=0)
    def leaf_of(tree, layer, leaf):
        period, i = divmod(layer, len(cfg.layer_pattern))
        if period < cfg.n_periods:
            return np.asarray(tree["layers"][f"block{i}"]["core"][leaf][period], np.float32)
        return np.asarray(tree["tail"][i]["core"][leaf], np.float32)

    n = 0
    for layer, kind in enumerate(cfg.layer_pattern * cfg.n_periods + cfg.tail_pattern):
        if kind not in ("rec", "ssd"):
            continue
        for leaf in leaves:
            key = f"layers.{layer}.core.{leaf}"
            np.testing.assert_allclose(state[key].numpy(), leaf_of(values, layer, leaf),
                                       rtol=1e-5, atol=0)
            assert state16[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(state16[key].float().numpy(),
                                          leaf_of(ref16, layer, leaf))
            n += 1
    assert n > 0


def test_mamba2_refuses_a_prefill_that_is_not_whole_chunks():
    """As the reference: a 40-token prefill against the reduced chunk of
    32 raises ValueError; 32 (one chunk) and 64 (two) run."""
    cfg, ref_cfg, values, model = _models("mamba2-370m")
    toks = np.ones((1, 40), np.int32)
    with pytest.raises(ValueError, match="L=40 must be divisible by chunk=32"):
        _ref_prefill(values, ref_cfg, jnp.asarray(toks), ref_tf.init_caches(ref_cfg, 1, 64))
    with torch.inference_mode():
        with pytest.raises(ValueError, match="L=40 must be divisible by chunk=32"):
            model.prefill(torch.from_numpy(toks), model.init_caches(1, 64))
        for n in (7, 32, 64):
            model.prefill(torch.ones((1, n), dtype=torch.int32), model.init_caches(1, 64))
