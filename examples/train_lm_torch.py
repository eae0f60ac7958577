"""End-to-end LM training through the port's fault-tolerant trainer.

    PYTHONPATH=src python examples/train_lm_torch.py                # on the card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu   # CPU-sized
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --arch gemma2-9b

The counterpart of ``examples/train_lm.py``: a reduced config of the chosen
architecture, the synthetic Markov corpus, AdamW with warmup-cosine, and
periodic async checkpoints — kill it mid-run and restart it with the same
``--ckpt-dir`` to see the restore path replay from the last checkpoint.
On the card the attention runs through K7 and its gradient through K7b;
on the CPU through their plain versions.
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.data.lm_data import make_batch_iterator
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optim import get_optimizer, warmup_cosine
from repro_torch.train.step import init_state, make_train_step


def main(total_steps=60, ckpt_dir="/tmp/repro_torch_train_lm", arch="gemma2-9b",
         seq_len=64, batch=8, device=None):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("example", "train", seq_len, batch)
    opt = get_optimizer("adamw", warmup_cosine(5e-3, 10, total_steps))
    model = Decoder(cfg, device=device, seed=None)

    def init():
        model.reset_parameters(0)
        n = sum(p.numel() for p in model.parameters())
        print(f"{arch} (reduced): {n / 1e6:.2f}M params on {model.device}")
        return init_state(model, opt)

    trainer = Trainer(
        step_fn=make_train_step(model, opt),
        init_state_fn=init,
        batch_iter_fn=lambda start: make_batch_iterator(cfg, shape, seed=0,
                                                        start_step=start),
        cfg=TrainerConfig(total_steps=total_steps, ckpt_every=20,
                          ckpt_dir=ckpt_dir, async_ckpt=True),
    )
    out = trainer.run()
    trainer.ckpt.close()
    h = out["history"]
    print(f"steps={out['steps']} restarts={out['n_restarts']} "
          f"loss {h[0]['loss']:.3f} → {h[-1]['loss']:.3f} "
          f"({out['wall_time_s']:.1f}s)")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--arch", default="gemma2-9b")
    p.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args()
    main(total_steps=a.steps, ckpt_dir=a.ckpt_dir, arch=a.arch, device=a.device)
