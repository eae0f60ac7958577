"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against the
reference's ``moe_fwd`` (its single-device path), and the MoE × FCA example
against the reference's.

Held within 2e-5 at float32: ``y`` and the load-balance ``aux``.  Exactly:
the dropped assignments (the reference's, counted from its own top-k
decisions and capacity: at least one in the capacity-factor case), none at
decode's exact capacity, the lower expert id on equal router
probabilities, the capacity on a ``.5`` rounding edge (Python's
half-to-even ``round``) and the concept set the example mines from the same
router decisions.  Top-2 with the dense residual (arctic) and top-1 with
the shared expert (llama4), each ``reduced()``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_reference import jax_reference  # noqa: F401  (module fixture)
from repro.configs import get_config as ref_get_config
from repro.core import ClosureEngine as RefClosureEngine
from repro.core import FormalContext as RefFormalContext
from repro.core import mrganter_plus as ref_mrganter_plus
from repro.data.lm_data import make_batch_iterator as ref_batch_iterator
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.models.config import ShapeConfig as RefShapeConfig
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import moe
from repro_torch.models.transformer import Decoder

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["arctic-480b", "llama4-scout-17b-a16e"]
TOL = dict(atol=2e-5, rtol=2e-5)
# the reference's moe_fwd compiled once per config and shape (its eager
# dispatch of the sort-based scatter is several times slower)
_ref_moe_fwd = jax.jit(ref_moe.moe_fwd, static_argnums=(2,), static_argnames=("exact",))


def _params(cfg, seed: int, router_scale: float = 0.5) -> dict:
    """A reference MoE tree, float32, from a numpy seed; the router wide
    enough that the routing is uneven."""
    rng = np.random.default_rng(seed)
    e, d = cfg.moe, cfg.d_model
    E, f = e.n_experts, e.d_ff_expert

    def normal(shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    p = {"router": normal((d, E), router_scale), "w_gate": normal((E, d, f), d**-0.5),
         "w_up": normal((E, d, f), d**-0.5), "w_down": normal((E, f, d), f**-0.5)}
    if e.shared_expert:
        p["shared"] = {"gate": normal((d, f), d**-0.5), "up": normal((d, f), d**-0.5),
                       "down": normal((f, d), f**-0.5)}
    return p


def _port(cfg, params) -> moe.MoE:
    m = moe.MoE(cfg, torch.float32, "cpu")
    m.load_state_dict(_flat(params))
    return m


def _flat(params, prefix=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


def _ref_drops(cfg, params, x, exact: bool) -> int:
    """Dropped assignments of the reference's dispatch, from its own top-k
    decisions: an expert's assignments past its capacity."""
    e = cfg.moe
    N = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x).reshape(N, -1) @ jnp.asarray(params["router"]), -1)
    _, top_i = jax.lax.top_k(probs, e.top_k)
    counts = np.bincount(np.asarray(top_i).reshape(-1), minlength=e.n_experts)
    C = N * e.top_k if exact else max(1, int(round(N * e.top_k / e.n_experts
                                                   * e.capacity_factor)))
    return int(np.maximum(counts - C, 0).sum())


def _check(cfg, params, x, exact: bool) -> int:
    ref_cfg = ref_get_config(cfg.name).reduced()
    want_y, want_aux = _ref_moe_fwd(jax.tree_util.tree_map(jnp.asarray, params),
                                    jnp.asarray(x), ref_cfg, exact=exact)
    port = _port(cfg, params)
    with torch.inference_mode():
        y, aux = port(torch.from_numpy(x), cfg, exact=exact)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    drops = _ref_drops(cfg, params, x, exact)
    assert int(port.dropped) == drops
    return drops


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_capacity_drops_as_the_reference(arch):
    """A prefill-shaped input [2, 24, d] at the capacity factor: the
    reference drops assignments, and the port gives its y and aux with the
    same drops."""
    cfg = get_config(arch).reduced()
    params = _params(cfg, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    x += np.float32(2.0) * x[:1, :1]  # a shared direction: uneven load
    assert _check(cfg, params, x, exact=False) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_decode_drops_nothing(arch):
    """Decode (``exact``): capacity N·k, so nothing drops on the same
    uneven routing."""
    cfg = get_config(arch).reduced()
    params = _params(cfg, seed=1)
    x = np.random.default_rng(3).standard_normal((6, 1, cfg.d_model)).astype(np.float32)
    x += np.float32(2.0) * x[:1]
    assert moe.capacity(6, cfg, exact=True) == 6 * cfg.moe.top_k
    assert _check(cfg, params, x, exact=True) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_equal_router_probabilities_pick_the_lower_expert_id(arch):
    """A zero router: every expert has probability 1/E, and the top k are
    experts 0 .. k-1 for every token, as ``jax.lax.top_k`` picks them."""
    cfg = get_config(arch).reduced()
    params = _params(cfg, seed=4)
    params["router"] = np.zeros_like(params["router"])
    x = np.random.default_rng(5).standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    _, top_w, top_i = moe.route(torch.from_numpy(params["router"]),
                                torch.from_numpy(x.reshape(16, -1)), cfg.moe.top_k)
    assert top_i.tolist() == [list(range(cfg.moe.top_k))] * 16
    torch.testing.assert_close(top_w, torch.full_like(top_w, 1.0 / cfg.moe.top_k))
    _check(cfg, params, x, exact=False)


@pytest.mark.parametrize("arch,N,C", [("llama4-scout-17b-a16e", 8, 2),
                                      ("llama4-scout-17b-a16e", 24, 8),
                                      ("arctic-480b", 4, 2), ("arctic-480b", 12, 8)])
def test_capacity_rounds_half_to_even(arch, N, C):
    """N·k/E·1.25 = 2.5 or 7.5 (E = 4): Python's round gives 2 and 8, as the
    reference computes it; the dispatch at that N drops as the reference's."""
    cfg = get_config(arch).reduced()
    assert N * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor % 1 == 0.5
    assert moe.capacity(N, cfg, exact=False) == C
    params = _params(cfg, seed=6)
    x = np.random.default_rng(N).standard_normal((1, N, cfg.d_model)).astype(np.float32)
    x += np.float32(0.8) * x[:, :1]
    assert _check(cfg, params, x, exact=False) > 0


# -- the example ------------------------------------------------------------------------


def _example():
    spec = importlib.util.spec_from_file_location(
        "moe_expert_fca_torch", ROOT / "examples" / "moe_expert_fca_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_concepts_equal_the_reference_examples(jax_reference):
    """``examples/moe_expert_fca_torch.py`` on the reference example's
    weights (llama4 reduced, 8 experts top-2, ``init_params(seed=0)``) and
    batches: the reference example's router decisions (first MoE layer on
    the raw embeddings), and on them the reference's concept set, from the
    port's MRGanter+ on a simulated 4-shard rsag plan."""
    ex = _example()
    cfg = ex.example_config()
    ref_cfg = ref_get_config("llama4-scout-17b-a16e").reduced()
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, n_experts=8,
                                                                    top_k=2))
    values = jax.tree_util.tree_map(np.asarray, ref_tf.init_params(ref_cfg, seed=0)[0])
    model = Decoder(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(values, cfg))

    token_batches = ex.batches(cfg, 2)
    it = ref_batch_iterator(ref_cfg, RefShapeConfig("fca", "train", 64, 8), seed=0)
    router = values["layers"]["block0"]["moe"]["router"][0]
    want = []
    for tokens in token_batches:
        ref_tokens = next(it)[1]["inputs"]
        np.testing.assert_array_equal(tokens, ref_tokens)
        x = jnp.asarray(values["embed"])[ref_tokens].astype(jnp.float32)
        logits = x.reshape(-1, ref_cfg.d_model) @ jnp.asarray(router, jnp.float32)
        _, top_i = jax.lax.top_k(jax.nn.softmax(logits, -1), ref_cfg.moe.top_k)
        onehot = np.zeros((top_i.shape[0], ref_cfg.moe.n_experts), bool)
        for k in range(ref_cfg.moe.top_k):
            onehot[np.arange(top_i.shape[0]), np.asarray(top_i)[:, k]] = True
        want.append(onehot)
    want = np.concatenate(want)
    rows = ex.routing_rows(model, token_batches)
    np.testing.assert_array_equal(rows, want)

    ctx, res = ex.mine(rows, device="cpu")
    ref_ctx = RefFormalContext.from_dense(want)
    ref_res = ref_mrganter_plus(ref_ctx, RefClosureEngine(ref_ctx, n_parts=4,
                                                          reduce_impl="rsag",
                                                          use_kernel=False),
                                dedupe_candidates=True)
    assert res.n_concepts == ref_res.n_concepts and res.n_iterations == ref_res.n_iterations
    assert {y.tobytes() for y in res.intents} == {
        np.asarray(y, np.uint32).tobytes() for y in ref_res.intents}
