"""Training launcher of the port.

    python -m repro_torch.launch.train --arch <id> --shape train_4k \\
        [--reduced] [--steps N] [--ckpt-dir D] [--ckpt-every K] [--lr LR] \\
        [--mesh none|local] [--weights W.npz] [--device cpu]

The reference's ``repro.launch.train``: the arch's config (``--reduced``:
its ``reduced()`` form at sequence 64, batch 8), the arch plan's optimizer
(AdamW or Adafactor) with warmup-cosine (100 warmup steps), the synthetic
step-indexed corpus (seed 0), weights from seed 0 (or, with
``--weights``, an ``.npz`` of a reference parameter tree, as
``launch/serve`` takes it), and the fault-tolerant ``Trainer`` with async
checkpoints every ``--ckpt-every`` steps.  It prints the reference's
``done:`` line.

``--mesh none`` trains on one device with no partitioner.  ``--mesh
local`` builds ``make_local_mesh()`` over the ranks of the default
``torch.distributed`` group (all on ``data``; under ``torchrun`` one rank
a process), or over a one-rank group it starts itself when there is none
(NCCL on the card, gloo with ``--device cpu``), and trains through
``Partitioner(mesh, fsdp=plan.fsdp)``: the model and optimizer state
placed by ``state_shardings``, each batch on the data axes, checkpoints
restored onto the mesh.  ``production`` and ``multi-pod`` build
``make_production_mesh`` (16 × 16, 2 × 16 × 16), which raises on a group
of another size, as the reference raises on too few devices.
``--device`` defaults to ``cuda``; without a CUDA device the run fails
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_plan, get_shape
from repro_torch.data.lm_data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.dist.partition import Partitioner, replicate_plain
from repro_torch.interop import params_from_jax, unflatten_tree
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optim import get_optimizer, warmup_cosine

MESHES = ("local", "production", "multi-pod", "none")


def ensure_group(device: torch.device) -> bool:
    """Start the ``torch.distributed`` group when none is running: the
    launcher's (``torchrun`` sets RANK and WORLD_SIZE), else a one-rank
    group meeting at a free localhost port; NCCL on a CUDA device, gloo on
    the CPU.  Returns whether it started one."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://")
        return True
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    return True


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    p.add_argument("--ckpt-every", type=int, default=25)
    p.add_argument("--mesh", default="local", choices=MESHES)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weights", default=None,
                   help=".npz of a reference parameter tree (flatten_tree keys)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    plan = get_plan(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced", "train", 64, 8)
    else:
        shape = get_shape(args.shape)

    device = resolve_device(args.device)
    started = args.mesh != "none" and ensure_group(device)
    try:
        out = _train(args, cfg, plan, shape, device)
    finally:
        if started:
            dist.destroy_process_group()
    h = out["history"]
    print(f"done: steps={out['steps']} restarts={out['n_restarts']} "
          f"loss {h[0]['loss']:.4f} → {h[-1]['loss']:.4f}")
    return out


def _train(args, cfg, plan, shape, device) -> dict:
    part = None
    if args.mesh != "none":
        mesh = (make_local_mesh() if args.mesh == "local"
                else make_production_mesh(multi_pod=args.mesh == "multi-pod"))
        part = Partitioner(mesh, fsdp=plan.fsdp)

    opt = get_optimizer(plan.optimizer, warmup_cosine(args.lr, 100, args.steps))
    model = Decoder(cfg, device=device, seed=None)
    sh = None
    if part is not None:
        sh = tstep.model_state_shardings(part, model, opt)
        tstep.shard_model(model, part)
    weights = None
    if args.weights:
        with np.load(args.weights) as flat:
            weights = params_from_jax(unflatten_tree(dict(flat)), cfg)

    def init_state():
        # whole values into the placed parameters: each rank keeps its chunk
        with replicate_plain():
            if weights is None:
                model.reset_parameters(0)
            else:
                model.load_state_dict(weights)
        return tstep.init_state(model, opt, sh)

    trainer = Trainer(
        step_fn=tstep.make_train_step(model, opt, part),
        init_state_fn=init_state,
        batch_iter_fn=lambda start: make_batch_iterator(cfg, shape, seed=0,
                                                        start_step=start),
        cfg=TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, async_ckpt=True),
        state_shardings=sh,
    )
    try:
        return trainer.run()
    finally:
        trainer.ckpt.close()


if __name__ == "__main__":
    main()
