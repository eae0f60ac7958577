"""Batched serving engine: prefill once, decode in lock-step slots.

The port of the reference's ``repro.serve.engine``: requests are
left-padded to the longest prompt in a fixed slot batch (``valid_from``
marks each slot's first real token; pad keys are never attended),
prefilled together in one pass (K7 on every attention layer), then decoded
token-synchronously with per-slot EOS tracking and a ``max_len`` stop.
Greedy argmax, or temperature sampling from a ``torch.Generator`` seeded
by ``seed`` (its draws cannot match ``jax.random``'s; greedy tokens match
the reference's).  Each ``generate`` call leaves a :class:`GenerateStats`
behind: host-clock seconds of the prefill and of every decode step (each
ends in the host read of the sampled tokens, which waits for the card),
the prefill's last-position logits and each step's top-2 logits.

``partitioner`` (a ``repro_torch.dist.partition.Partitioner`` over a
mesh) serves the model sharded, as the reference's ``ServeEngine(...,
partitioner=)`` does: the model's parameters are placed by the
partitioner (``train.step.shard_model``), each batch's caches by
``cache_shardings`` and its tokens on the batch axes, and prefill and
decode run with ``shard`` (K7 on each rank's heads or query rows, the
expert-parallel MoE in the prefill); the logits are gathered whole before
sampling.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.dist.partition import distribute
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Decoder
from repro_torch.train.step import cache_shardings, shard_caches, shard_model


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 1024
    batch_slots: int = 8
    greedy: bool = True
    temperature: float = 1.0
    eos_id: int | None = None


@dataclasses.dataclass
class GenerateStats:
    prefill_s: float = 0.0
    decode_s: list = dataclasses.field(default_factory=list)
    prefill_logits: torch.Tensor | None = None  # [B, V] float32, last position
    top2: list = dataclasses.field(default_factory=list)  # per sampled step: [B, 2]


def left_pad(prompts: list[list[int]], slots: int) -> tuple[np.ndarray, np.ndarray]:
    """``(tokens [slots, plen] int32, valid_from [slots] int32)``: each
    prompt right-aligned so that every last token sits at ``plen - 1``;
    unused slots are all pad (``valid_from = plen``)."""
    plen = max(len(p) for p in prompts)
    toks = np.zeros((slots, plen), np.int32)
    valid_from = np.full((slots,), plen, np.int32)
    for i, p in enumerate(prompts):
        toks[i, plen - len(p):] = p
        valid_from[i] = plen - len(p)
    return toks, valid_from


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: Decoder, scfg: ServeConfig, *, device=None,
                 partitioner=None):
        dev = resolve_device(device)
        if model.device.type != dev.type:
            raise ValueError(f"the model lives on {model.device}, the engine runs on {dev}")
        self.cfg = cfg
        self.model = model
        self.scfg = scfg
        self.device = model.device
        self.stats = GenerateStats()
        self.shard = partitioner if (partitioner and partitioner.mesh is not None) else None
        if self.shard is not None:
            shard_model(model, self.shard)

    def _caches(self, B: int):
        caches = self.model.init_caches(B, self.scfg.max_len)
        if self.shard is None:
            return caches
        return shard_caches(caches, cache_shardings(self.shard, self.cfg, caches))

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(toks).to(self.device)
        return t if self.shard is None else distribute(t, self.shard.batch_spec(t.shape))

    @staticmethod
    def _whole(logits: torch.Tensor) -> torch.Tensor:
        return logits.full_tensor() if isinstance(logits, DTensor) else logits

    def _sample(self, logits: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
        last = logits[:, -1, :]
        self.stats.top2.append(last.topk(2, dim=-1).values)
        if self.scfg.greedy:
            return last.argmax(-1).to(torch.int32)
        probs = torch.softmax(last / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    def generate(self, prompts: list[list[int]], max_new: int, seed: int = 0):
        """Greedy/temperature generation for a list of prompts (in inference
        mode; under ``no_grad`` when sharded: DTensors take no inference
        tensors)."""
        with torch.no_grad() if self.shard is not None else torch.inference_mode():
            return self._generate(prompts, max_new, seed)

    def _generate(self, prompts: list[list[int]], max_new: int, seed: int):
        scfg = self.scfg
        B = scfg.batch_slots
        if len(prompts) > B:
            raise ValueError(f"{len(prompts)} prompts > {B} slots")
        toks, valid_from = left_pad(prompts, B)
        plen = toks.shape[1]
        self.stats = stats = GenerateStats()
        gen = None if scfg.greedy else torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        caches = self._caches(B)
        logits, caches = self.model.prefill(
            self._tokens(toks), caches, torch.from_numpy(valid_from).to(self.device),
            shard=self.shard)
        logits = self._whole(logits)
        stats.prefill_logits = logits[:, -1, :]
        out = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        tok = self._sample(logits, gen)
        host = tok.tolist()
        stats.prefill_s = time.perf_counter() - t0
        for step in range(max_new):
            t = plen + step
            for i in range(len(prompts)):
                if not done[i]:
                    v = host[i]
                    out[i].append(v)
                    if scfg.eos_id is not None and v == scfg.eos_id:
                        done[i] = True
            if done[: len(prompts)].all() or t >= scfg.max_len - 1:
                break
            t0 = time.perf_counter()
            logits, caches = self.model.decode_step(tok[:, None], t, caches, shard=self.shard)
            tok = self._sample(self._whole(logits), gen)
            host = tok.tolist()
            stats.decode_s.append(time.perf_counter() - t0)
        return out[: len(prompts)]
