"""The train and serve steps, and the partitioner's sharding trees.

The port of the reference's ``repro.train.step``: ``make_loss_fn``,
``make_train_step``, ``make_prefill_step`` and ``make_decode_step`` take a
``partitioner`` (``repro_torch.dist.partition.Partitioner``, or None for
one device), and ``state_shardings``, ``batch_shardings`` and
``cache_shardings`` give the :class:`~repro_torch.dist.partition.Sharding`
of every leaf of the train state, a batch and the caches.  The state is a
dict of tensors:

    state = {"params": {name: tensor}, "opt": {...}, "step": int32 0-dim}

where ``params`` are the model's own parameters (``Decoder.trainable()``),
so the step differentiates the module as it is and the optimizer writes
the new values into those tensors in place (the returned state holds the
same tensors).  A batch is numpy arrays or tensors (``inputs``,
``labels``, optionally ``positions``); it is moved to the model's device.

Under a partitioner the model's parameters are DTensors placed by
:func:`shard_model` (``state_shardings``' ``params``), the optimizer state
by :func:`shard_state`, and each batch is placed by ``batch_shardings``
(every rank holds the whole batch and keeps its chunk); the step then runs
on DTensors, its gradients and updates placed as the parameters, and its
metrics are DTensors (``float()`` of one sums or gathers it on the way).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.partition import distribute, replicate_plain_in_backward
from repro_torch.models import transformer


def init_state(model, optimizer, shardings=None) -> dict:
    """A train state over ``model``'s parameters, at step 0; ``shardings``
    (``state_shardings``) places its optimizer state and step (the
    parameters are the model's, placed by :func:`shard_model`)."""
    params = model.trainable()
    state = {"params": params, "opt": optimizer.init(params, model.stacks()),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if shardings is not None:
        state = {"params": params, "opt": shard_state(state["opt"], shardings["opt"]),
                 "step": distribute(state["step"], shardings["step"])}
    return state


def batch_to(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device`` (float inputs keep their
    dtype; the model casts them)."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def place_batch(batch: dict, device, partitioner=None) -> dict:
    """:func:`batch_to`, and under a partitioner each array placed by
    ``batch_shardings`` (this rank's chunk of the whole batch)."""
    batch = batch_to(batch, device)
    part = transformer.active_shard(partitioner)
    if part is None:
        return batch
    sh = batch_shardings(part, batch)
    return {k: distribute(v, sh[k]) for k, v in batch.items()}


def make_loss_fn(model, partitioner=None):
    """``loss_fn(params, batch) -> (loss, metrics)``; ``params`` must be
    ``model``'s own parameters (the train state's)."""
    shard = transformer.active_shard(partitioner)

    def loss_fn(params, batch):
        return transformer.train_loss_fn(model, place_batch(batch, model.device, shard),
                                         shard=shard)

    return loss_fn


def make_train_step(model, optimizer, partitioner=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradient with respect to every parameter, the optimizer's
    update, ``step + 1``; metrics ``loss``, ``xent``, ``moe_aux`` and
    ``grad_norm`` (the float32 norm of all gradients), as 0-dim tensors on
    the device (DTensors under a partitioner)."""
    shard = transformer.active_shard(partitioner)
    loss_fn = make_loss_fn(model, shard)
    stacks = model.stacks()

    def train_step(state, batch):
        params = state["params"]
        with transformer.shard_context(shard):
            with torch.enable_grad():
                loss, metrics = loss_fn(params, batch)
                if shard is not None:
                    replicate_plain_in_backward(loss)
                # a parameter the loss does not read (the embedding of an
                # ``embeds`` input) gets a zero gradient, as under jax.grad
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                            materialize_grads=True)
            grads = dict(zip(params, grads))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(g.to(torch.float32).square().sum()
                                       for g in grads.values()))
            new_params, new_opt = optimizer.apply(grads, state["opt"], params, stacks)
            del grads
            metrics = {"xent": metrics["xent"].detach(), "moe_aux": metrics["moe_aux"].detach(),
                       "loss": loss.detach(), "grad_norm": gnorm}
            return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step


def make_prefill_step(model, partitioner=None):
    """``prefill_step(params, inputs, caches, rope_positions=None) ->
    (logits [B, 1, V], caches)``; ``params`` are the model's own."""
    shard = transformer.active_shard(partitioner)

    def prefill_step(params, inputs, caches, rope_positions=None, valid_from=None):
        return model.prefill(inputs, caches, valid_from=valid_from,
                             rope_positions=rope_positions, shard=shard)

    return prefill_step


def make_decode_step(model, partitioner=None):
    """``decode_step(params, inputs, t, caches, rope_positions=None) ->
    (logits [B, 1, V], caches)``."""
    shard = transformer.active_shard(partitioner)

    def decode_step(params, inputs, t, caches, rope_positions=None):
        return model.decode_step(inputs, t, caches, rope_positions=rope_positions, shard=shard)

    return decode_step


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------


def state_shardings(partitioner, params_axes: dict, abstract_params: dict, optimizer,
                    stacks: dict | None = None) -> dict:
    """The :class:`Sharding` of every leaf of the train state: the
    parameters' from their logical axes (``Decoder.param_axes()``) and
    shapes (anything with ``.shape``, by name), the optimizer state's from
    ``optimizer.state_axes`` over its leaves' shapes (``optimizer.init`` on
    meta tensors: nothing is allocated), the step replicated.  ``stacks``:
    ``Decoder.stacks()`` (Adafactor's period-stacked leaves)."""
    p_sh = partitioner.tree_shardings(params_axes, abstract_params)
    meta = {k: torch.empty(tuple(v.shape), device="meta") for k, v in abstract_params.items()}
    abstract_opt = optimizer.init(meta, stacks)
    o_sh = partitioner.tree_shardings(optimizer.state_axes(params_axes, stacks), abstract_opt)
    return {"params": p_sh, "opt": o_sh, "step": partitioner.replicated()}


def model_state_shardings(partitioner, model, optimizer) -> dict:
    """:func:`state_shardings` of ``model``'s parameters."""
    return state_shardings(partitioner, model.param_axes(), dict(model.named_parameters()),
                           optimizer, model.stacks())


def batch_shardings(partitioner, abstract_batch: dict) -> dict:
    """Every array of a batch on the batch axes (its dim 0; M-RoPE
    positions ``[3, B, S]`` on dim 1)."""
    out = {}
    for k, v in abstract_batch.items():
        if k == "positions" and len(v.shape) == 3:  # mrope [3, B, S]
            out[k] = partitioner.batch_spec(v.shape, batch_dim=1)
        else:
            out[k] = partitioner.batch_spec(v.shape, batch_dim=0)
    return out


def cache_shardings(partitioner, cfg, abstract_caches) -> list:
    """The caches (``Decoder.init_caches``): batch over the data axes, KV
    heads (``kv``), Griffin's ``lru`` and SSD's ``inner`` / ``heads`` over
    ``model`` where they divide — from ``transformer.cache_axes``."""
    return partitioner.tree_shardings(transformer.cache_axes(cfg), abstract_caches)


def shard_state(tree, shardings):
    """Each leaf of ``tree`` (nested dicts of tensors, the same on every
    rank) placed by the matching :class:`Sharding` of ``shardings``."""
    if isinstance(tree, dict):
        return {k: shard_state(v, shardings[k]) for k, v in tree.items()}
    return distribute(tree, shardings)


def shard_caches(caches: list, shardings: list) -> list:
    """The caches (one NamedTuple a layer) placed by ``cache_shardings``."""
    return [type(c)(*(distribute(x, sh) for x, sh in zip(c, shs)))
            for c, shs in zip(caches, shardings)]


def shard_model(model, partitioner):
    """Place every parameter of ``model`` as ``state_shardings``' ``params``
    say (each rank keeps its chunk of its own copy: no communication); a
    parameter that is a DTensor already is left as it is.  Returns the
    model."""
    axes = model.param_axes()
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        if hasattr(p, "placements"):
            continue
        sh = partitioner.sharding(axes[name], p.shape)
        setattr(owner, leaf, torch.nn.Parameter(distribute(p.detach(), sh),
                                                requires_grad=p.requires_grad))
    return model
