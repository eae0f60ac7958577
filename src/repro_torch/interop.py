"""Hand state across from the reference's numpy arrays and back.

The parity tests build one context with the reference and feed the very
same rows to the port through :func:`context_from_arrays`; a rule table
crosses through :func:`basis_from_arrays`, so the rule-serving kernels
can be held against the reference on one and the same table.  A concept
store needs no helper: ``ConceptStore.build(ctx, intents)`` takes numpy
intents.  LM weights cross as the reference's parameter tree with numpy
leaves: :func:`params_from_jax` turns it into the port's ``Decoder``
state, :func:`flatten_tree` / :func:`unflatten_tree` store it in an
``.npz``, and :func:`numpy_params` makes one from a numpy seed that both
packages can load.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.context import FormalContext
from repro_torch.rules.basis import RuleBasis, RuleSet


def context_from_arrays(
    rows_u32: np.ndarray, n_objects: int, n_attrs: int
) -> FormalContext:
    """The port's :class:`FormalContext` over packed ``uint32`` rows."""
    return FormalContext(
        rows=np.array(rows_u32, dtype=np.uint32, copy=True),
        n_objects=int(n_objects),
        n_attrs=int(n_attrs),
    )


def to_numpy(ctx: FormalContext) -> tuple[np.ndarray, int, int]:
    """``(rows_u32, n_objects, n_attrs)`` of a port context."""
    return np.array(ctx.rows, dtype=np.uint32, copy=True), ctx.n_objects, ctx.n_attrs


def basis_from_arrays(
    premise: np.ndarray,
    added: np.ndarray,
    support: np.ndarray,
    confidence: np.ndarray,
    lift: np.ndarray,
    n_implications: int,
    *,
    n_objects: int,
    n_attrs: int,
    min_conf: float,
) -> RuleBasis:
    """The port's :class:`RuleBasis` over a combined rule table: the first
    ``n_implications`` rows are the implications, the rest the partial
    rules (the layout of the reference's ``RuleBasis.combined()``).
    Every array is copied, in the dtypes the port's ``RuleSet`` holds."""
    arrays = (
        np.array(premise, dtype=np.uint32, copy=True),
        np.array(added, dtype=np.uint32, copy=True),
        np.array(support, dtype=np.int32, copy=True),
        np.array(confidence, dtype=np.float32, copy=True),
        np.array(lift, dtype=np.float32, copy=True),
    )
    n = int(n_implications)
    return RuleBasis(
        n_objects=int(n_objects),
        n_attrs=int(n_attrs),
        min_conf=float(min_conf),
        implications=RuleSet(*(a[:n] for a in arrays)),
        partial=RuleSet(*(a[n:] for a in arrays)),
    )


# ---------------------------------------------------------------------------
# LM parameters: the reference's tree ↔ the port's Decoder state
# ---------------------------------------------------------------------------


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts / lists of arrays → ``{"a/b/0/c": array}`` (for ``.npz``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, sub in items:
        out.update(flatten_tree(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def unflatten_tree(flat) -> dict:
    """The inverse of :func:`flatten_tree`: a level whose keys are all digits
    becomes a list."""
    root: dict = {}
    for path, arr in flat.items():
        node = root
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = np.asarray(arr)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def params_from_jax(values, cfg) -> dict:
    """The reference's parameter tree (``transformer.init_params(cfg)[0]``
    with numpy leaves: ``embed``, ``final_norm``, ``unembed``, the
    period-stacked ``layers/block{i}/...`` and the unrolled ``tail``) → the
    state dict of ``repro_torch.models.transformer.Decoder(cfg)``.  Period
    ``p``'s ``block{i}`` is layer ``period·p + i``; the tail follows.  Every
    leaf keeps the reference's shape and layout; arrays are copied."""
    import torch

    def put(out, key, arr):
        out[key] = torch.from_numpy(np.array(arr, copy=True))

    def block(out, layer, tree, pick=None):
        for path, arr in flatten_tree(tree).items():
            put(out, f"layers.{layer}.{path.replace('/', '.')}",
                arr if pick is None else arr[pick])

    out: dict = {}
    put(out, "embed", values["embed"])
    put(out, "final_norm.scale", values["final_norm"]["scale"])
    if "unembed" in values:
        put(out, "unembed", values["unembed"])
    P = len(cfg.layer_pattern)
    for p in range(cfg.n_periods):
        for i in range(P):
            block(out, P * p + i, values["layers"][f"block{i}"], pick=p)
    for j, tree in enumerate(values.get("tail", [])):
        block(out, P * cfg.n_periods + j, tree)
    return out


def numpy_params(cfg, seed: int) -> dict:
    """A parity tree in the reference's layout, float32, from
    ``np.random.default_rng(seed)``: dense leaves ``N(0, 1/fan_in)``,
    embeddings ``N(0, 0.02²)`` (``ParamBuilder``'s scales), and — unlike
    the reference's init, so that every parameter is exercised — norm
    scales ``N(0, 0.1²)`` and biases ``N(0, 0.02²)`` in place of zeros.
    The JAX package and the port both take it (``params_from_jax``)."""
    rng = np.random.default_rng(seed)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    def dense(shape, fan_in=None):
        return normal(shape, 1.0 / np.sqrt(max(1, fan_in or shape[0])))

    def one_block(lead=()):
        core = {"wq": dense(lead + (d, H, hd), d), "wk": dense(lead + (d, KV, hd), d),
                "wv": dense(lead + (d, KV, hd), d), "wo": dense(lead + (H, hd, d), H * hd)}
        if cfg.qkv_bias:
            core.update(bq=normal(lead + (H, hd), 0.02), bk=normal(lead + (KV, hd), 0.02),
                        bv=normal(lead + (KV, hd), 0.02))
        mlp = {"up": dense(lead + (d, cfg.d_ff), d), "down": dense(lead + (cfg.d_ff, d),
                                                                   cfg.d_ff)}
        if cfg.mlp_kind in ("swiglu", "geglu"):
            mlp["gate"] = dense(lead + (d, cfg.d_ff), d)
        p = {"pre_norm": {"scale": normal(lead + (d,), 0.1)}, "core": core,
             "pre_mlp_norm": {"scale": normal(lead + (d,), 0.1)}, "mlp": mlp}
        if cfg.post_norm:
            p["post_norm"] = {"scale": normal(lead + (d,), 0.1)}
            p["post_mlp_norm"] = {"scale": normal(lead + (d,), 0.1)}
        return p

    tree = {"embed": normal((cfg.vocab_size, d), 0.02),
            "final_norm": {"scale": normal((d,), 0.1)}}
    if not cfg.tie_embeddings:
        tree["unembed"] = dense((d, cfg.vocab_size))
    if cfg.n_periods > 0:
        tree["layers"] = {f"block{i}": one_block((cfg.n_periods,))
                          for i in range(len(cfg.layer_pattern))}
    if cfg.tail_pattern:
        tree["tail"] = [one_block() for _ in cfg.tail_pattern]
    return tree
