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


def axes_from_jax(axes, cfg) -> dict:
    """The reference's logical-axes tree of the parameters (the axes half of
    ``layers.split_params``) → ``{port parameter name: axes}``, named as
    :func:`params_from_jax` names the values: a period-stacked leaf gives
    every layer of its block its axes without the leading ``layers``
    entry (``Decoder.param_axes()`` holds the same)."""

    def leaves(tree, prefix=""):
        if isinstance(tree, tuple) and all(a is None or isinstance(a, str) for a in tree):
            return {prefix: tree}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, sub in items:
            out.update(leaves(sub, f"{prefix}.{key}" if prefix else str(key)))
        return out

    out = {k: v for k, v in leaves(axes).items() if not k.startswith(("layers.", "tail."))}
    P = len(cfg.layer_pattern)
    for p in range(cfg.n_periods):
        for i in range(P):
            for path, ax in leaves(axes["layers"][f"block{i}"]).items():
                if ax[:1] != ("layers",):
                    raise ValueError(f"stacked leaf {path} lacks its 'layers' axis: {ax}")
                out[f"layers.{P * p + i}.{path}"] = ax[1:]
    for j, tree in enumerate(axes.get("tail", [])):
        for path, ax in leaves(tree).items():
            out[f"layers.{P * cfg.n_periods + j}.{path}"] = ax
    return out


def opt_state_from_jax(values, cfg) -> dict:
    """The reference's optimizer state with numpy leaves (``adamw``: ``step``,
    ``m``, ``v``, ``master``; ``adafactor``: ``step``, ``v``) → the port's
    (``repro_torch.train.optim``), float32 CPU tensors.  AdamW's three trees
    map leaf for leaf as :func:`params_from_jax` maps the parameters;
    Adafactor's statistics keep the reference's leaves: a period-stacked
    leaf under its path (``layers/block{i}/...``, the key of
    ``Decoder.stacks()``), the others under the port's parameter names."""
    import torch

    step = torch.from_numpy(np.array(values["step"], dtype=np.int32, copy=True))
    if "m" in values:
        return {"step": step, **{k: params_from_jax(values[k], cfg)
                                 for k in ("m", "v", "master")}}
    P = len(cfg.layer_pattern)
    v: dict = {}
    for path, arr in flatten_tree(values["v"]).items():
        *leaf, stat = path.split("/")
        if leaf[0] == "layers":
            key = "/".join(leaf)
        elif leaf[0] == "tail":
            key = ".".join(["layers", str(P * cfg.n_periods + int(leaf[1])), *leaf[2:]])
        else:
            key = ".".join(leaf)
        v.setdefault(key, {})[stat] = torch.from_numpy(np.array(arr, copy=True))
    return {"step": step, "v": v}


def numpy_params(cfg, seed: int) -> dict:
    """A parity tree in the reference's layout, float32, from
    ``np.random.default_rng(seed)``: dense leaves ``N(0, 1/fan_in)``,
    embeddings ``N(0, 0.02²)`` and the MoE router ``N(0, 0.02²)``
    (``ParamBuilder``'s scales), and — unlike the reference's init, so that
    every parameter is exercised — norm scales ``N(0, 0.1²)`` and biases
    ``N(0, 0.02²)`` in place of zeros, and the value leaves at the
    reference's formulas (Griffin's ``lam``, SSD's ``A_log`` and
    ``dt_bias``) or ones (``D``) plus ``N(0, 0.1²)``.  Every kind of layer
    and FFN of the ten configs; the JAX package and the port both take it
    (``params_from_jax``)."""
    rng = np.random.default_rng(seed)
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    def dense(shape, fan_in=None):
        return normal(shape, 1.0 / np.sqrt(max(1, fan_in or shape[0])))

    def value(lead, v, noise=0.0):
        v = np.broadcast_to(np.asarray(v, np.float32), lead + np.shape(v))
        return (v + normal(v.shape, noise)) if noise else np.array(v)

    def mlp_tree(lead, f, kind):
        mlp = {"up": dense(lead + (d, f), d), "down": dense(lead + (f, d), f)}
        if kind in ("swiglu", "geglu"):
            mlp["gate"] = dense(lead + (d, f), d)
        return mlp

    def attn_core(lead):
        core = {"wq": dense(lead + (d, H, hd), d), "wk": dense(lead + (d, KV, hd), d),
                "wv": dense(lead + (d, KV, hd), d), "wo": dense(lead + (H, hd, d), H * hd)}
        if cfg.qkv_bias:
            core.update(bq=normal(lead + (H, hd), 0.02), bk=normal(lead + (KV, hd), 0.02),
                        bv=normal(lead + (KV, hd), 0.02))
        return core

    def rec_core(lead):
        w, K = cfg.griffin.lru_width or d, cfg.griffin.conv_width
        lam = np.log(np.expm1(-np.log(np.linspace(0.9, 0.999, w)) / 8.0))
        return {"proj_rec": dense(lead + (d, w), d), "proj_gate": dense(lead + (d, w), d),
                "conv_w": dense(lead + (K, w), K), "conv_b": normal(lead + (w,), 0.02),
                "w_a": dense(lead + (w, w), w), "b_a": normal(lead + (w,), 0.02),
                "w_x": dense(lead + (w, w), w), "b_x": normal(lead + (w,), 0.02),
                "lam": value(lead, lam, 0.1), "proj_out": dense(lead + (w, d), w)}

    def ssd_core(lead):
        s = cfg.ssm
        d_in = s.expand * d
        nh = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.state_size
        return {"in_proj": dense(lead + (d, 2 * d_in + 2 * s.n_groups * s.state_size + nh), d),
                "conv_w": dense(lead + (s.conv_width, conv_dim), s.conv_width),
                "conv_b": normal(lead + (conv_dim,), 0.02),
                "A_log": value(lead, np.log(np.linspace(1.0, 16.0, nh)), 0.1),
                "D": value(lead, np.ones(nh), 0.1),
                "dt_bias": value(lead, np.log(np.expm1(np.full(nh, 0.01))), 0.1),
                "norm": normal(lead + (d_in,), 0.1),
                "out_proj": dense(lead + (d_in, d), d_in)}

    def moe_tree(lead):
        e = cfg.moe
        E, f = e.n_experts, e.d_ff_expert
        tree = {"router": normal(lead + (d, E), 0.02), "w_gate": dense(lead + (E, d, f), d),
                "w_up": dense(lead + (E, d, f), d), "w_down": dense(lead + (E, f, d), f)}
        if e.shared_expert:
            tree["shared"] = mlp_tree(lead, f, "swiglu")
        return tree

    def one_block(kind, lead=()):
        core = (rec_core if kind == "rec" else ssd_core if kind == "ssd" else attn_core)(lead)
        ffn = {}
        if kind != "ssd":
            if cfg.moe is not None:
                ffn["moe"] = moe_tree(lead)
            if cfg.moe is None or cfg.moe.dense_residual:
                ffn["mlp"] = mlp_tree(lead, cfg.d_ff, cfg.mlp_kind)
        p = {"pre_norm": {"scale": normal(lead + (d,), 0.1)}, "core": core}
        if kind != "ssd":
            p["pre_mlp_norm"] = {"scale": normal(lead + (d,), 0.1)}
        p.update(ffn)
        if cfg.post_norm:
            p["post_norm"] = {"scale": normal(lead + (d,), 0.1)}
            if kind != "ssd":
                p["post_mlp_norm"] = {"scale": normal(lead + (d,), 0.1)}
        return p

    tree = {"embed": normal((cfg.vocab_size, d), 0.02),
            "final_norm": {"scale": normal((d,), 0.1)}}
    if not cfg.tie_embeddings:
        tree["unembed"] = dense((d, cfg.vocab_size))
    if cfg.n_periods > 0:
        tree["layers"] = {f"block{i}": one_block(kind, (cfg.n_periods,))
                          for i, kind in enumerate(cfg.layer_pattern)}
    if cfg.tail_pattern:
        tree["tail"] = [one_block(kind) for kind in cfg.tail_pattern]
    return tree
