"""Optimizers (AdamW, Adafactor) and the warmup-cosine schedule.

The port of the reference's ``repro.train.optim``, as plain functions on
tensors (``torch.optim`` updates differently and is not used).  The state
is the reference's: AdamW keeps float32 ``m``, ``v`` and ``master`` copies
of every parameter (16 bytes a parameter with bf16 compute parameters and
their gradients), keyed by the parameters' names; Adafactor keeps, for each
leaf of two or more axes, the row and column statistics ``vr`` / ``vc`` of
its last two axes, else a full ``v``, keyed by the reference's leaves (see
:func:`adafactor`); ``step`` is an int32 0-dim tensor on the parameters'
device.

``apply(grads, state, params)`` returns ``(params, state)`` like the
reference's, but updates in place where that saves memory: the moments
and the master copy are updated in place, and each parameter is written
from its new value in place, so the returned ``params`` are the very
tensors passed in (at full width the state holds 13 bytes a parameter
that a second copy would double).  The schedule and the bias corrections
are float32 0-dim tensors computed on the device from ``step``, as the
reference computes them in float32: no host read per step.
``state_axes(params_axes, stacks=None)`` gives the logical axes of every
state leaf from the parameters' (``Decoder.param_axes()``), for the
partitioner's ``tree_shardings``: AdamW's three trees take the
parameters' axes; Adafactor's ``vr`` drops a leaf's last axis and ``vc``
its second-to-last, a period-stacked leaf taking the reference's leading
``layers`` entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch


def warmup_cosine(peak_lr: float, warmup: int, total: int) -> Callable:
    """``lr(step)``: linear warmup to ``peak_lr`` over ``warmup`` steps,
    then a cosine to 0 at ``total``; float32 throughout (a 0-dim tensor in,
    a 0-dim float32 tensor out)."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = peak_lr * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # (params, stacks=None) -> opt_state
    apply: Callable  # (grads, opt_state, params, stacks=None) -> (params, opt_state)
    state_axes: Callable  # (params_axes, stacks=None) -> the opt state's logical axes


def _step_of(params: dict) -> torch.Tensor:
    device = next(iter(params.values())).device if params else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW with bias correction and decoupled weight decay on the float32
    master copy; the parameter is the master rounded to its dtype."""

    def init(params: dict, stacks: dict | None = None) -> dict:
        with torch.no_grad():
            return {
                "step": _step_of(params),
                "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
                # a copy even for float32 parameters (the reference's copy=True)
                "master": {k: p.detach().to(torch.float32, copy=True)
                           for k, p in params.items()},
            }

    @torch.no_grad()
    def apply(grads: dict, state: dict, params: dict, stacks: dict | None = None):
        step = state["step"] + 1
        lr = lr_fn(step)
        stepf = step.to(torch.float32)
        b1t = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
        b2t = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
        for name, p in params.items():
            g = grads[name].to(torch.float32)
            m, v, master = state["m"][name], state["v"][name], state["master"][name]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            # at most two float32 temporaries of the parameter's size
            update = m.div(b1t).div_(v.div(b2t).sqrt_().add_(eps))
            update.add_(master, alpha=weight_decay)
            master.sub_(update.mul_(lr))
            del update
            p.copy_(master)
        state["step"] = step
        return params, state

    def state_axes(params_axes: dict, stacks: dict | None = None) -> dict:
        return {"step": (), "m": dict(params_axes), "v": dict(params_axes),
                "master": dict(params_axes)}

    return Optimizer(init, apply, state_axes)


def _factored(shape) -> bool:
    return len(shape) >= 2


def _units(params: dict, stacks: dict | None) -> list:
    """The leaves the reference's Adafactor sees: each group of ``stacks``
    (the reference's period-stacked leaf → the layers' parameter names, in
    period order) as one leaf stacked on a new first axis, every other
    parameter as itself.  Returns ``(key, names, stacked)`` triples."""
    stacks = stacks or {}
    grouped = {n for names in stacks.values() for n in names}
    return ([(k, list(names), True) for k, names in stacks.items()]
            + [(n, [n], False) for n in params if n not in grouped])


def adafactor(lr_fn: Callable, decay: float = 0.99, eps: float = 1e-30, clip_rms: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Adafactor without momentum: the second moment factored over the last
    two axes (``vr`` the mean over the columns, ``vc`` over the rows, the
    rank-1 estimate ``vr ⊗ vc / mean(vr)``), full ``v`` for vectors and
    scalars; the update clipped to RMS ``clip_rms``.

    The reference applies it to its scan-stacked tree, where each leaf of
    the repeated layers holds every period on a leading axis: the factoring
    of a layer's vector and the RMS clip of every leaf span the periods.
    ``stacks`` (``Decoder.stacks()``) gives that grouping, and the state is
    kept per reference leaf (keyed by its path) so the update is the
    reference's; without it each parameter is a leaf of its own."""

    def init(params: dict, stacks: dict | None = None) -> dict:
        def leaf(shape, device):
            if not _factored(shape):
                return {"v": torch.zeros(shape, dtype=torch.float32, device=device)}
            return {"vr": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                      device=device)}

        v = {}
        for key, names, stacked in _units(params, stacks):
            p = params[names[0]]
            v[key] = leaf(((len(names),) if stacked else ()) + tuple(p.shape), p.device)
        return {"step": _step_of(params), "v": v}

    @torch.no_grad()
    def apply(grads: dict, state: dict, params: dict, stacks: dict | None = None):
        step = state["step"] + 1
        lr = lr_fn(step)
        for key, names, stacked in _units(params, stacks):
            if stacked:
                g = torch.stack([grads[n] for n in names]).to(torch.float32)
                p = torch.stack([params[n] for n in names])
            else:
                g, p = grads[key].to(torch.float32), params[key]
            g2 = g.square() + eps
            v = state["v"][key]
            if not _factored(g.shape):
                v["v"].mul_(decay).add_(g2 * (1 - decay))
                precond = g * torch.rsqrt(v["v"] + eps)
            else:
                v["vr"].mul_(decay).add_(g2.mean(-1) * (1 - decay))
                v["vc"].mul_(decay).add_(g2.mean(-2) * (1 - decay))
                mean_r = torch.clamp_min(v["vr"].mean(-1, keepdim=True), eps)
                v_est = (v["vr"] / mean_r)[..., :, None] * v["vc"][..., None, :]
                precond = g * torch.rsqrt(v_est + eps)
            del g2
            rms = torch.sqrt(precond.square().mean() + eps)
            precond = precond / torch.clamp_min(rms / clip_rms, 1.0)
            pf = p.to(torch.float32)
            new = (pf - lr * (precond + weight_decay * pf)).to(p.dtype)
            for i, n in enumerate(names):
                params[n].copy_(new[i] if stacked else new)
        state["step"] = step
        return params, state

    def state_axes(params_axes: dict, stacks: dict | None = None) -> dict:
        def leaf(ax):
            if not _factored(ax):
                return {"v": ax}
            return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}

        return {"step": (), "v": {
            key: leaf((("layers",) if stacked else ()) + tuple(params_axes[names[0]]))
            for key, names, stacked in _units(params_axes, stacks)}}

    return Optimizer(init, apply, state_axes)


def get_optimizer(name: str, lr_fn: Callable) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    raise ValueError(f"unknown optimizer {name!r}")
