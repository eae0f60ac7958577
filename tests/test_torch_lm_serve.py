"""The port's LM serving path against the JAX package.

The reference's parameters (``transformer.init_params(cfg.reduced(),
seed=0)``, numpy leaves) cross to the port through
``interop.params_from_jax``; the same token ids go through both.  Held
equal, at float32 within 2e-5 (absolute and relative: sum order only):
the layers (rms_norm, RoPE, M-RoPE, each MLP kind), the full forward
(train mode) and its logits, prefill with left pads and prompts longer
than the reduced window (its last-position logits and every real cache
slot), and decode steps past the window (the ring caches).  Exact: the
cache positions, and the greedy tokens of ``ServeEngine.generate``
(including the reference's three ``tests/test_serve.py`` properties) and
of ``launch/serve.py``, whose printed lines equal the reference CLI's.
The other families (Griffin, Mamba-2, MoE, embedding inputs) are held in
``tests/test_torch_lm_families.py`` and ``tests/test_torch_moe.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve_cli
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve.engine import ServeEngine as RefServeEngine
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.interop import flatten_tree, numpy_params, params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers
from repro_torch.models.transformer import Decoder
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.engine import left_pad

ARCHS = ["gemma2-9b", "codeqwen1.5-7b", "starcoder2-7b", "deepseek-coder-33b"]
TOL = dict(atol=2e-5, rtol=2e-5)
_cache: dict = {}


def _models(arch: str):
    """(config, reference values with numpy leaves, port Decoder on the CPU)."""
    if arch not in _cache:
        cfg = get_config(arch).reduced()
        values, _ = ref_tf.init_params(ref_get_config(arch).reduced(), seed=0)
        values = jax.tree_util.tree_map(np.asarray, values)
        model = Decoder(cfg, device="cpu", seed=None)
        model.load_state_dict(params_from_jax(values, cfg))
        _cache[arch] = (cfg, values, model)
    return _cache[arch]


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lengths]


# -- layers -------------------------------------------------------------------


def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) + np.array([[0], [5]], np.int32)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
            np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **TOL)
    mpos = np.stack([pos, pos * 2, pos + 3])  # three distinct streams
    np.testing.assert_allclose(
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(mpos), 10_000.0,
                           (2, 3, 3)).numpy(),
        np.asarray(ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(mpos), 10_000.0,
                                          (2, 3, 3))), **TOL)
    with pytest.raises(ValueError, match="sum to head_dim"):
        layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(mpos), 1.0, (2, 3, 4))
    np.testing.assert_allclose(
        layers.softcap(torch.from_numpy(x * 40), 30.0).numpy(),
        np.asarray(ref_layers.softcap(jnp.asarray(x * 40), 30.0)), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_kinds_match_the_reference(kind):
    rng = np.random.default_rng(1)
    d, f = 24, 40
    params = {"up": rng.standard_normal((d, f)).astype(np.float32) / 5,
              "down": rng.standard_normal((f, d)).astype(np.float32) / 6}
    if kind != "gelu":
        params["gate"] = rng.standard_normal((d, f)).astype(np.float32) / 5
    x = rng.standard_normal((3, 7, d)).astype(np.float32)
    mlp = layers.MLP(d, f, kind, torch.float32, "cpu")
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    want = ref_layers.mlp_fwd({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
                              kind)
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               **TOL)


# -- the decoder -----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_forward_matches_the_reference(arch):
    cfg, values, model = _models(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 45)).astype(np.int32)
    hidden, _, _ = ref_tf.forward_hidden(values, ref_get_config(arch).reduced(),
                                         jnp.asarray(toks), mode="train")
    want = ref_tf.logits_for(values, ref_get_config(arch).reduced(), hidden)
    with torch.inference_mode():
        got_h, caches, aux = model.forward_hidden(torch.from_numpy(toks), mode="train")
        got = model.logits_for(got_h)
    assert caches is None and got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got_h.numpy(), np.asarray(hidden), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """Left-padded prompts, the longest past the reduced window (32), then
    decode steps that wrap the ring caches."""
    cfg, values, model = _models(arch)
    ref_cfg = ref_get_config(arch).reduced()
    toks, vf = left_pad(_prompts(cfg, [41, 17, 1], seed=3), 3)
    B, max_len = toks.shape[0], 64
    ref_caches = ref_tf.init_caches(ref_cfg, B, max_len)
    want, ref_caches = ref_tf.prefill(values, ref_cfg, jnp.asarray(toks), ref_caches,
                                      valid_from=jnp.asarray(vf))
    with torch.inference_mode():
        caches = model.init_caches(B, max_len)
        got, caches = model.prefill(torch.from_numpy(toks), caches, torch.from_numpy(vf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_caches(cfg, caches, ref_caches)

    tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    t = toks.shape[1]
    for step in range(6):
        want, ref_caches = ref_tf.decode_step(values, ref_cfg, jnp.asarray(tok[:, None]),
                                              t + step, ref_caches)
        with torch.inference_mode():
            got, caches = model.decode_step(torch.from_numpy(tok[:, None]), t + step, caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
    _check_caches(cfg, caches, ref_caches)


def _check_caches(cfg, caches, ref_caches):
    """Every layer's cache: positions exactly, k and v on the real slots."""
    ref_layers_list = []
    P = len(cfg.layer_pattern)
    for p in range(cfg.n_periods):
        for i in range(P):
            ref_layers_list.append(jax.tree_util.tree_map(
                lambda a, p=p: np.asarray(a)[p], ref_caches["layers"][f"block{i}"]))
    ref_layers_list += [jax.tree_util.tree_map(np.asarray, c)
                        for c in ref_caches.get("tail", [])]
    assert len(caches) == len(ref_layers_list) == cfg.n_layers
    for got, want in zip(caches, ref_layers_list):
        np.testing.assert_array_equal(got.pos.numpy(), want.pos)
        real = want.pos >= 0
        np.testing.assert_allclose(got.k.numpy()[real], want.k[real], **TOL)
        np.testing.assert_allclose(got.v.numpy()[real], want.v[real], **TOL)


def test_a_tail_layer_maps_after_the_periods():
    """gemma2 reduced to 5 layers: two periods and a one-layer tail, mapped
    onto layers 0-3 and 4 of the port's flat list."""
    import dataclasses

    ref_cfg = dataclasses.replace(ref_get_config("gemma2-9b").reduced(), n_layers=5)
    cfg = dataclasses.replace(get_config("gemma2-9b").reduced(), n_layers=5)
    assert cfg.tail_pattern == ("attn_local",)
    values = jax.tree_util.tree_map(np.asarray, ref_tf.init_params(ref_cfg, seed=1)[0])
    model = Decoder(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(values, cfg))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    want, _, _ = ref_tf.forward_hidden(values, ref_cfg, jnp.asarray(toks), mode="train")
    with torch.inference_mode():
        got, _, _ = model.forward_hidden(torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_numpy_params_load_into_both_packages():
    """The parity tree of chip_smoke's reduced serve phase: the same numpy
    leaves drive the reference and the port to the same logits."""
    cfg = get_config("gemma2-9b").reduced()
    tree = numpy_params(cfg, seed=20260101)
    assert tree["layers"]["block0"]["pre_norm"]["scale"].std() > 0  # norms exercised
    model = Decoder(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(tree, cfg))
    toks = np.random.default_rng(5).integers(0, 256, size=(1, 12)).astype(np.int32)
    ref_cfg = ref_get_config("gemma2-9b").reduced()
    values = jax.tree_util.tree_map(jnp.asarray, tree)
    hidden, _, _ = ref_tf.forward_hidden(values, ref_cfg, jnp.asarray(toks), mode="train")
    with torch.inference_mode():
        got, _, _ = model.forward_hidden(torch.from_numpy(toks), mode="train")
    np.testing.assert_allclose(got.numpy(), np.asarray(hidden), **TOL)


# -- the serving engine ---------------------------------------------------------------


def _engines(arch="codeqwen1.5-7b", greedy=True, eos=None, max_len=96):
    cfg, values, model = _models(arch)
    ref = RefServeEngine(ref_get_config(arch).reduced(), values,
                         RefServeConfig(max_len=max_len, batch_slots=4, greedy=greedy,
                                        eos_id=eos))
    port = ServeEngine(cfg, model, ServeConfig(max_len=max_len, batch_slots=4, greedy=greedy,
                                               eos_id=eos), device="cpu")
    return cfg, model, ref, port


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_the_reference_greedy_tokens(arch):
    cfg, _, ref, port = _engines(arch)
    prompts = _prompts(cfg, [40, 3, 9], seed=6)
    kernels.reset_launches()
    got = port.generate(prompts, max_new=12)
    assert got == ref.generate(prompts, max_new=12)
    assert [len(o) for o in got] == [12] * 3
    assert kernels.flash_attention.blockwise_attention.launches == 0  # CPU: plain versions
    stats = port.stats
    # as in the reference, a decode step follows every appended token but
    # the one the max_new stop ends on
    assert len(stats.decode_s) == 12 and stats.prefill_logits.shape == (4, cfg.vocab_size)
    assert len(stats.top2) == 13


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma2-9b"])
def test_out_of_range_token_ids_answer_as_the_reference(arch):
    """Ids V, V + 5, -1, -V and -V - 3 gather as the reference's embedding
    gather takes them (a negative id counts from the end, then the id is
    clamped to [0, V - 1]): the same greedy tokens, where the port raised
    before."""
    cfg, _, ref, port = _engines(arch, max_len=48)
    V = cfg.vocab_size
    prompts = [[V, 1], [V + 5, -1, 3], [-V, 7], [-V - 3, 9, 2]]
    got = port.generate(prompts, max_new=3)
    assert got == ref.generate(prompts, max_new=3)
    assert port.generate([[V + 5, 1]], max_new=3) == port.generate([[V - 1, 1]], max_new=3)
    assert port.generate([[-V - 3, 7]], max_new=3) == port.generate([[0, 7]], max_new=3)
    assert port.generate([[-1, 7]], max_new=3) == port.generate([[V - 1, 7]], max_new=3)


def test_generate_matches_manual_greedy():
    cfg, model, _, port = _engines()
    prompt = [5, 9, 2, 14, 7]
    out = port.generate([prompt], max_new=8)[0]
    assert len(out) == 8
    seq = list(prompt)
    with torch.inference_mode():
        for _ in range(8):
            hidden, _, _ = model.forward_hidden(torch.tensor([seq]), mode="train")
            seq.append(int(model.logits_for(hidden)[0, -1].argmax()))
    assert out == seq[len(prompt):]


def test_generate_batch_isolation():
    """Each slot decodes independently of the others (left-padding safe)."""
    _, _, _, port = _engines()
    a = port.generate([[3, 1, 4]], max_new=6)[0]
    b = port.generate([[3, 1, 4], [9, 9, 9, 9]], max_new=6)[0]
    assert a == b


def test_eos_stops_early():
    _, _, ref, port = _engines()
    first = port.generate([[1, 2, 3]], max_new=1)[0][0]
    _, _, ref2, port2 = _engines(eos=first)
    assert port2.generate([[1, 2, 3]], max_new=8)[0] == [first]
    assert ref2.generate([[1, 2, 3]], max_new=8)[0] == [first]


def test_max_len_stops_generation():
    cfg, _, ref, port = _engines(max_len=20)
    prompts = _prompts(cfg, [15, 4], seed=8)
    got = port.generate(prompts, max_new=30)
    assert got == ref.generate(prompts, max_new=30)
    assert [len(o) for o in got] == [5, 5]


def test_temperature_sampling_is_seeded():
    cfg, _, _, port = _engines(greedy=False)
    prompts = _prompts(cfg, [6, 2], seed=9)
    a = port.generate(prompts, max_new=6, seed=3)
    assert a == port.generate(prompts, max_new=6, seed=3)
    assert all(0 <= t < cfg.vocab_size for o in a for t in o)


# -- the CLI ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "gemma2-9b"])
def test_cli_prints_what_the_reference_cli_prints(capsys, tmp_path, arch):
    argv = ["--arch", arch, "--reduced", "--prompts", "1,2,3;4,5,6,7;300,7", "--max-new", "6"]
    ref_serve_cli.main(argv)
    want = capsys.readouterr().out
    values, _ = ref_tf.init_params(ref_get_config(arch).reduced(), seed=0)
    path = tmp_path / "weights.npz"
    np.savez(path, **flatten_tree(jax.tree_util.tree_map(np.asarray, values)))
    serve_cli.main(argv + ["--weights", str(path), "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 3 and "→" in got
    serve_cli.main(argv + ["--device", "cpu"])  # seeded torch weights: the same format
    own = capsys.readouterr().out.splitlines()
    assert [line.split(" → ")[0] for line in own] == [line.split(" → ")[0]
                                                      for line in want.splitlines()]


def test_chip_smoke_reduced_tokens_are_the_references():
    """chip_smoke.py's pinned tokens of its reduced LM serve phase are what
    the reference derives on the numpy weights (tests/_torch_reference.py),
    and what the port gives on the CPU from the same weights."""
    import sys
    from pathlib import Path

    from _torch_reference import lm_constants

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    assert lm_constants() == cs.LM_REDUCED_EXPECTED
    for arch in cs.LM_REDUCED_ARCHS:
        cfg = get_config(arch).reduced()
        model = Decoder(cfg, device="cpu", seed=None)
        model.load_state_dict(params_from_jax(numpy_params(cfg, cs.LM_SEED), cfg))
        prompts = cs.lm_prompts_for(arch, cfg.vocab_size)
        window = cfg.attn_window or (cfg.griffin.attn_window if cfg.griffin else None)
        assert max(map(len, prompts)) > window if window else True
        ids = [t for p in prompts for t in p]
        assert min(ids) < -cfg.vocab_size and max(ids) > cfg.vocab_size  # C2's ids
        eng = ServeEngine(cfg, model, ServeConfig(max_len=cs.LM_REDUCED_MAX_LEN,
                                                  batch_slots=max(4, len(prompts))),
                          device="cpu")
        assert eng.generate(prompts, cs.LM_MAX_NEW) == cs.LM_REDUCED_EXPECTED[arch]
