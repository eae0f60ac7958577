"""The train step: loss, gradients, optimizer update.

The port of the reference's ``repro.train.step`` (``make_loss_fn``,
``make_train_step``) on one device: the partitioner's sharding trees
(``state_shardings``, ``batch_shardings``, ``cache_shardings``) wait for
``dist/partition.py``.  The state is a dict of tensors:

    state = {"params": {name: tensor}, "opt": {...}, "step": int32 0-dim}

where ``params`` are the model's own parameters (``Decoder.trainable()``),
so the step differentiates the module as it is and the optimizer writes
the new values into those tensors in place (the returned state holds the
same tensors).  A batch is numpy arrays or tensors (``inputs``,
``labels``, optionally ``positions``); it is moved to the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer


def init_state(model, optimizer) -> dict:
    """A train state over ``model``'s parameters, at step 0."""
    params = model.trainable()
    return {"params": params, "opt": optimizer.init(params, model.stacks()),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def batch_to(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device`` (float inputs keep their
    dtype; the model casts them)."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def make_loss_fn(model):
    """``loss_fn(params, batch) -> (loss, metrics)``; ``params`` must be
    ``model``'s own parameters (the train state's)."""

    def loss_fn(params, batch):
        return transformer.train_loss_fn(model, batch_to(batch, model.device))

    return loss_fn


def make_train_step(model, optimizer):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    and its gradient with respect to every parameter, the optimizer's
    update, ``step + 1``; metrics ``loss``, ``xent``, ``moe_aux`` and
    ``grad_norm`` (the float32 norm of all gradients), as 0-dim tensors on
    the device."""
    loss_fn = make_loss_fn(model)
    stacks = model.stacks()

    def train_step(state, batch):
        params = state["params"]
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            # a parameter the loss does not read (the embedding of an
            # ``embeds`` input) gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                        materialize_grads=True)
        grads = dict(zip(params, grads))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads.values()))
        new_params, new_opt = optimizer.apply(grads, state["opt"], params, stacks)
        del grads
        metrics = {"xent": metrics["xent"].detach(), "moe_aux": metrics["moe_aux"].detach(),
                   "loss": loss.detach(), "grad_norm": gnorm}
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step
