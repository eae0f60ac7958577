"""Fault-tolerant training loop.

The port of the reference's ``repro.train.loop``.  Beyond calling the step:
  * periodic (optionally async) checkpoints through ``CheckpointManager``;
  * **restart on failure**: any exception in a step (an injected fault in
    ``fault_hook``, a failed launch, the NaN guard) restores the latest
    checkpoint and replays from it; the data pipeline is step-indexed, so
    the replayed batches are the same;
  * the NaN guard: a non-finite loss counts as a failure;
  * ``max_retries`` failures in a row re-raise.
The step's loss is read to the host once per step, as in the reference
(the NaN guard and ``history`` need it).  A restart drops the failed
state before it builds the fresh one and restores into it (in place), so
a full-width state is never held twice.  ``state_shardings`` (the
partitioner's ``train.step.state_shardings``) restores the checkpoint
onto this run's mesh, whatever mesh (or none) saved it.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    async_ckpt: bool = False
    max_retries: int = 3
    nan_guard: bool = True


class Trainer:
    def __init__(
        self,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        init_state_fn: Callable,  # () -> state
        batch_iter_fn: Callable,  # (start_step) -> iterator of (step, batch)
        cfg: TrainerConfig,
        state_shardings=None,
        fault_hook: Callable | None = None,  # test hook: (step) -> None, may raise
    ):
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.batch_iter_fn = batch_iter_fn
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.fault_hook = fault_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep, async_save=cfg.async_ckpt)
        self.history: list[dict] = []
        self.n_restarts = 0

    def _fresh_or_restored(self):
        state = self.init_state_fn()
        latest = self.ckpt.latest()
        if latest is not None:
            state = self.ckpt.restore(state, self.state_shardings, step=latest)
            start = int(state["step"])
            log.info("restored checkpoint at step %d", start)
            return state, start
        return state, 0

    def run(self) -> dict:
        cfg = self.cfg
        retries = 0
        state, start = self._fresh_or_restored()
        it = self.batch_iter_fn(start)
        step = start
        t0 = time.perf_counter()
        while step < cfg.total_steps:
            failed = None
            try:
                data_step, batch = next(it)
                if data_step != step:
                    raise RuntimeError(f"the data iterator gave step {data_step} at step {step}")
                if self.fault_hook is not None:
                    self.fault_hook(step)
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])
                if cfg.nan_guard and not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                self.history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
                step += 1
                retries = 0
                if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                    self.ckpt.save(step, state)
            except Exception as e:  # noqa: BLE001 — the restart-from-checkpoint path
                # without its traceback: the failed step's frames (and the
                # tensors they hold) go before the fresh state is built
                failed = e.with_traceback(None)
            if failed is None:
                continue
            retries += 1
            self.n_restarts += 1
            log.warning("step %d failed (%s); restart %d/%d", step, failed, retries,
                        cfg.max_retries)
            if retries > cfg.max_retries:
                raise failed
            self.ckpt.wait()
            state = it = None
            state, step = self._fresh_or_restored()
            it = self.batch_iter_fn(step)
        self.ckpt.wait()
        return {
            "final_state": state,
            "steps": step,
            "wall_time_s": time.perf_counter() - t0,
            "n_restarts": self.n_restarts,
            "history": self.history,
        }
