"""Batched serving with prefill + lock-step decode, on the PyTorch port.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2-370m --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch recurrentgemma-2b   # CUDA

The port of ``examples/serve_lm.py``: one ``reduced()`` config of any of
the ten archs, seeded weights on the device, the reference example's four
prompts in four slots and greedy tokens; prints each prompt's tokens and
the host-clock rate.  ``--embeds`` (qwen2-vl-72b, musicgen-large) prefills
from the ``lm_data`` stub's embeddings [4, 8, d] instead of token ids, then
decodes greedily from the model's own tokens.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.lm_data import make_batch_iterator
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import Decoder
from repro_torch.serve import ServeConfig, ServeEngine


@torch.inference_mode()
def embeds_generate(model: Decoder, max_new: int) -> list:
    """Greedy tokens after a prefill from the stub's embeddings [4, 8, d]
    (and its M-RoPE streams for an M-RoPE config)."""
    cfg = model.cfg
    _, batch = next(make_batch_iterator(cfg, ShapeConfig("serve", "prefill", 8, 4), seed=0))
    x = torch.from_numpy(batch["inputs"]).to(model.device)
    pos = batch.get("positions")
    caches = model.init_caches(4, 8 + max_new)
    logits, caches = model.prefill(x, caches, rope_positions=None if pos is None else
                                   torch.from_numpy(pos).to(model.device))
    out = []
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    for step in range(max_new):
        out.append(tok.tolist())
        if step + 1 < max_new:
            logits, caches = model.decode_step(tok[:, None], 8 + step, caches)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
    return np.array(out).T.tolist()


def main(arch="codeqwen1.5-7b", max_new=24, device=None, embeds=False):
    cfg = get_config(arch).reduced()
    model = Decoder(cfg, device=device, seed=0)
    t0 = time.perf_counter()
    if embeds:
        if cfg.input_mode != "embeds":
            raise SystemExit(f"--embeds needs an embeds config; {arch} takes token ids")
        prompts = ["<embeds>"] * 4
        outs = embeds_generate(model, max_new)
    else:
        eng = ServeEngine(cfg, model, ServeConfig(max_len=256, batch_slots=4), device=device)
        prompts = [[1, 5, 42, 7], [9, 9, 3], [100, 20, 30, 40, 50], [2]]
        outs = eng.generate(prompts, max_new=max_new)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    for p, o in zip(prompts, outs):
        print(f"prompt {p} → {o}")
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, "
          f"batch={len(prompts)}, greedy, {model.device})")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="codeqwen1.5-7b")
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--embeds", action="store_true")
    a = p.parse_args()
    main(arch=a.arch, max_new=a.max_new, device=a.device, embeds=a.embeds)
