"""Training launcher of the port.

    python -m repro_torch.launch.train --arch <id> --shape train_4k \\
        [--reduced] [--steps N] [--ckpt-dir D] [--ckpt-every K] [--lr LR] \\
        [--mesh none|local] [--weights W.npz] [--device cpu]

The reference's ``repro.launch.train`` on one device: the arch's config
(``--reduced``: its ``reduced()`` form at sequence 64, batch 8), the arch
plan's optimizer (AdamW or Adafactor) with warmup-cosine (100 warmup
steps), the synthetic step-indexed corpus (seed 0), weights from seed 0
(or, with ``--weights``, an ``.npz`` of a reference parameter tree, as
``launch/serve`` takes it), and the fault-tolerant ``Trainer`` with async checkpoints every
``--ckpt-every`` steps.  It prints the reference's ``done:`` line.
``--mesh none`` and ``--mesh local`` run on one device (a one-device local
mesh shards nothing); ``production`` and ``multi-pod`` exit with the
reason: sharding the state over a mesh is the partitioner's slice
(``dist/partition.py``), not yet ported.  ``--device`` defaults to
``cuda``; without a CUDA device the run fails unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, get_plan, get_shape
from repro_torch.data.lm_data import make_batch_iterator
from repro_torch.interop import params_from_jax, unflatten_tree
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optim import get_optimizer, warmup_cosine

MESHES = ("local", "production", "multi-pod", "none")


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

    if args.mesh in ("production", "multi-pod"):
        raise SystemExit(f"--mesh {args.mesh} shards the train state over a device mesh, which "
                         "needs the partitioner (dist/partition.py, a later slice of the "
                         "port); use --mesh none or local")

    cfg = get_config(args.arch)
    plan = get_plan(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig("reduced", "train", 64, 8)
    else:
        shape = get_shape(args.shape)

    opt = get_optimizer(plan.optimizer, warmup_cosine(args.lr, 100, args.steps))
    model = Decoder(cfg, device=args.device, seed=None)
    weights = None
    if args.weights:
        with np.load(args.weights) as flat:
            weights = params_from_jax(unflatten_tree(dict(flat)), cfg)

    def init_state():
        if weights is None:
            model.reset_parameters(0)
        else:
            model.load_state_dict(weights)
        return tstep.init_state(model, opt)

    trainer = Trainer(
        step_fn=tstep.make_train_step(model, opt),
        init_state_fn=init_state,
        batch_iter_fn=lambda start: make_batch_iterator(cfg, shape, seed=0,
                                                        start_step=start),
        cfg=TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, async_ckpt=True),
    )
    out = trainer.run()
    trainer.ckpt.close()
    h = out["history"]
    print(f"done: steps={out['steps']} restarts={out['n_restarts']} "
          f"loss {h[0]['loss']:.4f} → {h[-1]['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
